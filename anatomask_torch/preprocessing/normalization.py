"""Intensity normalization schemes: the port's own copy of
anatomask_tpu/preprocessing/normalization.py (nnU-Net's default
normalization schemes and channel-name mapping).

Schemes: ZScore (optionally masked to the nonzero region), CT (clip to global
foreground percentiles then z-score with global foreground mean/std from the
dataset fingerprint), NoNormalization, RescaleTo01, RGBTo01.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Type

import numpy as np


class ImageNormalization(ABC):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = None

    def __init__(self, use_mask_for_norm: bool = None,
                 intensityproperties: dict = None,
                 target_dtype=np.float32):
        assert use_mask_for_norm is None or isinstance(use_mask_for_norm, bool)
        self.use_mask_for_norm = use_mask_for_norm
        self.intensityproperties = intensityproperties or {}
        self.target_dtype = target_dtype

    @abstractmethod
    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        """Normalize one channel (x, y, z). seg < 0 marks outside-mask voxels."""
        ...


class ZScoreNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = True

    def run(self, image, seg=None):
        image = image.astype(self.target_dtype, copy=True)
        if self.use_mask_for_norm is not None and self.use_mask_for_norm:
            # only normalize inside the nonzero mask (seg >= 0), keep outside at 0
            mask = seg >= 0
            mean = image[mask].mean()
            std = image[mask].std()
            image[mask] = (image[mask] - mean) / max(std, 1e-8)
        else:
            mean = image.mean()
            std = image.std()
            image = (image - mean) / max(std, 1e-8)
        return image


class CTNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        assert self.intensityproperties, "CTNormalization requires intensity properties from the fingerprint"
        image = image.astype(self.target_dtype, copy=True)
        mean = float(self.intensityproperties["mean"])
        std = float(self.intensityproperties["std"])
        lower = float(self.intensityproperties["percentile_00_5"])
        upper = float(self.intensityproperties["percentile_99_5"])
        np.clip(image, lower, upper, out=image)
        image -= mean
        image /= max(std, 1e-8)
        return image


class NoNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        return image.astype(self.target_dtype)


class RescaleTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        image = image.astype(self.target_dtype, copy=True)
        image -= image.min()
        image /= np.clip(image.max(), a_min=1e-8, a_max=None)
        return image


class RGBTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        assert image.min() >= 0 and image.max() <= 255, "RGB image values must be in [0, 255]"
        return image.astype(self.target_dtype) / 255.0


_SCHEMES = {
    "ZScoreNormalization": ZScoreNormalization,
    "CTNormalization": CTNormalization,
    "CT": CTNormalization,
    "NoNormalization": NoNormalization,
    "RescaleTo01Normalization": RescaleTo01Normalization,
    "RGBTo01Normalization": RGBTo01Normalization,
}


def get_normalization_scheme(name: str) -> Type[ImageNormalization]:
    if name not in _SCHEMES:
        raise RuntimeError(f"Unknown normalization scheme {name!r}. Known: {sorted(_SCHEMES)}")
    return _SCHEMES[name]


def channel_name_to_normalization_scheme(channel_name: str) -> str:
    """Modality name -> scheme, matching the reference's channel mapping."""
    lower = channel_name.lower()
    if lower == "ct":
        return "CTNormalization"
    if lower in ("noNorm".lower(), "none", "label"):
        return "NoNormalization"
    if lower in ("rescale_to_0_1", "rescale"):
        return "RescaleTo01Normalization"
    if lower in ("rgb_to_0_1", "rgb"):
        return "RGBTo01Normalization"
    return "ZScoreNormalization"

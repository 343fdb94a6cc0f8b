"""Gaussian importance map for sliding-window blending: the port's own copy of
anatomask_tpu/inference/gaussian.py (sigma = tile_size/8, centered impulse
blurred, normalized to max=value_scaling, zeros replaced by the smallest
nonzero value). Computed once per tile size on the host (scipy) and cached;
the caller moves it to the device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
from scipy.ndimage import gaussian_filter


@lru_cache(maxsize=8)
def compute_gaussian(tile_size: Tuple[int, ...], value_scaling_factor: float = 1.0
                     ) -> np.ndarray:
    """float32 (tile_size) map; the cached array is shared, so callers copy it
    before they change it."""
    tmp = np.zeros(tile_size)
    center = tuple(i // 2 for i in tile_size)
    sigmas = [i / 8 for i in tile_size]
    tmp[center] = 1
    gauss = gaussian_filter(tmp, sigmas, 0, mode="constant", cval=0)
    gauss = gauss / gauss.max() * value_scaling_factor
    gauss = gauss.astype(np.float32)
    mask = gauss == 0
    if mask.any():
        gauss[mask] = gauss[~mask].min()
    return gauss

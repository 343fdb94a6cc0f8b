"""Reader/writer interface: the port's own copy of
anatomask_tpu/imageio/base.py.

Contract: read_images(list of per-channel files) -> ((c, x, y, z) float32,
properties dict with at least 'spacing' aligned to the array axes);
write_seg(seg, path, properties) must round-trip geometry.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Tuple, Union

import numpy as np


class BaseReaderWriter(ABC):
    supported_file_endings: List[str] = []

    @staticmethod
    def _check_all_same(input_list) -> bool:
        return all(i == input_list[0] for i in input_list[1:])

    @staticmethod
    def _check_all_same_array(input_list) -> bool:
        return all(
            i.shape == input_list[0].shape and np.allclose(i, input_list[0])
            for i in input_list[1:]
        )

    @abstractmethod
    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]) -> Tuple[np.ndarray, dict]:
        """Read one image per channel; returns ((c, x, y, z) float32, properties).

        properties must contain 'spacing': [sx, sy, sz] aligned with the array's
        spatial axes, and whatever the writer needs to restore geometry.
        """
        ...

    @abstractmethod
    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        """Read a segmentation; returns ((1, x, y, z), properties)."""
        ...

    @abstractmethod
    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        """Write a (x, y, z) integer segmentation restoring original geometry."""
        ...

"""2D natural-image reader/writer (PNG/JPEG/BMP via PIL, imported inside the
functions): the port's own copy of anatomask_tpu/imageio/natural_image.py
(nnU-Net's NaturalImage2DIO) — 2D images as (c, 1, H, W) with unit spacing;
RGB images become 3 channels; segmentations written as single-channel PNG.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from anatomask_torch.imageio.base import BaseReaderWriter


class NaturalImage2DIO(BaseReaderWriter):
    supported_file_endings = [".png", ".bmp", ".tif", ".jpg", ".jpeg"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        from PIL import Image
        images = []
        for f in image_fnames:
            arr = np.asarray(Image.open(f))
            if arr.ndim == 3:  # (H, W, C) -> channels first
                arr = arr.transpose(2, 0, 1)
            else:
                arr = arr[None]
            images.append(arr[:, None].astype(np.float32))  # (c, 1, H, W)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {[i.shape for i in images]}")
        stacked = np.vstack(images)
        return stacked, {"spacing": [999.0, 1.0, 1.0]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        from PIL import Image
        arr = np.asarray(Image.open(seg_fname))
        if arr.ndim == 3:
            arr = arr[..., 0]
        return arr[None, None].astype(np.float32), {"spacing": [999.0, 1.0, 1.0]}

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        from PIL import Image
        assert seg.ndim == 3 and seg.shape[0] == 1, "expected (1, H, W) segmentation"
        Image.fromarray(seg[0].astype(np.uint8)).save(output_fname)

"""3D TIFF reader/writer (multi-page TIFF via PIL, imported inside the
functions): the port's own copy of anatomask_tpu/imageio/tiff_io.py
(nnU-Net's Tiff3DIO) — 3D stacks from .tif(f) files, spacing from a
'<name>.json' sidecar ({"spacing": [sz, sy, sx]}), segmentations written back
as multi-page TIFF + sidecar.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from anatomask_torch.imageio.base import BaseReaderWriter


def _read_tiff_stack(fname: str) -> np.ndarray:
    from PIL import Image, ImageSequence
    with Image.open(fname) as im:
        frames = [np.asarray(f) for f in ImageSequence.Iterator(im)]
    return np.stack(frames)  # (Z, H, W)


def _sidecar_path(fname: str) -> str:
    base = fname
    for ending in (".tiff", ".tif"):
        if base.endswith(ending):
            base = base[: -len(ending)]
            break
    return base + ".json"


class Tiff3DIO(BaseReaderWriter):
    supported_file_endings = [".tif", ".tiff"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            arr = _read_tiff_stack(f)
            assert arr.ndim == 3, f"expected a 3D stack in {f}, got {arr.shape}"
            images.append(arr.astype(np.float32))
            sc = _sidecar_path(f)
            if os.path.isfile(sc):
                with open(sc) as fh:
                    spacings.append([float(s) for s in json.load(fh)["spacing"]])
            else:
                spacings.append([1.0, 1.0, 1.0])
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {[i.shape for i in images]}")
        return np.stack(images), {"spacing": spacings[0]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        from PIL import Image
        assert seg.ndim == 3
        frames = [Image.fromarray(s.astype(np.uint8)) for s in seg]
        frames[0].save(output_fname, save_all=True, append_images=frames[1:])
        with open(_sidecar_path(output_fname), "w") as f:
            json.dump({"spacing": list(map(float, properties.get("spacing", [1, 1, 1])))}, f)

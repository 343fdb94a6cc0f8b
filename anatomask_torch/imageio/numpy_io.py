"""Numpy .npy/.npz reader/writer for synthetic/integration-test datasets: the
port's own copy of anatomask_tpu/imageio/numpy_io.py. It makes the
framework testable without any medical-format files. Spacing comes from an
optional .json sidecar {"spacing": [...]}, default 1mm.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from anatomask_torch.imageio.base import BaseReaderWriter


class NumpyIO(BaseReaderWriter):
    supported_file_endings = [".npy", ".npz"]

    @staticmethod
    def _load(fname: str) -> np.ndarray:
        if fname.endswith(".npz"):
            with np.load(fname) as z:
                return z[list(z.keys())[0]]
        return np.load(fname)

    @staticmethod
    def _sidecar(fname: str) -> dict:
        base = fname[: -len(".npz")] if fname.endswith(".npz") else fname[: -len(".npy")]
        sc = base + ".json"
        if os.path.isfile(sc):
            with open(sc) as f:
                return json.load(f)
        return {}

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            arr = self._load(f)
            if arr.ndim == 2:
                arr = arr[None]
            assert arr.ndim == 3, f"expected 3D array in {f}, got {arr.shape}"
            images.append(arr.astype(np.float32))
            sc = self._sidecar(f)
            spacings.append([float(s) for s in sc.get("spacing", [1.0, 1.0, 1.0])])
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image channel shapes differ: {[i.shape for i in images]}")
        return np.stack(images), {"spacing": spacings[0]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        seg = seg.astype(np.uint8 if seg.max() < 255 else np.uint16)
        if output_fname.endswith(".npz"):
            np.savez_compressed(output_fname, seg=seg)
        else:
            np.save(output_fname, seg)
        base = output_fname.rsplit(".", 1)[0]
        with open(base + ".json", "w") as f:
            json.dump({"spacing": list(map(float, properties.get("spacing", [1, 1, 1])))}, f)

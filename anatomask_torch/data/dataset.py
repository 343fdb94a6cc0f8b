"""Preprocessed-case store. The port's own copy of anatomask_tpu/data/dataset.py
(lazy case dict, memory-mapped .npy preferred over .npz; `unpack_dataset`
npz -> npy for mmap reads; a cascade stage's previous-stage segmentation
stacked under the labels)."""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from anatomask_torch.preprocessing.preprocessor import load_properties


def _unpack_case(npz_file: str):
    base = npz_file[:-4]
    with np.load(npz_file) as z:
        if not os.path.isfile(base + ".npy"):
            np.save(base + ".npy", z["data"])
        if not os.path.isfile(base + "_seg.npy"):
            np.save(base + "_seg.npy", z["seg"])


def unpack_dataset(folder: str, num_processes: int = 4):
    """npz -> npy so training reads are memory-mapped (done once at train
    start; a case already unpacked is left as it is)."""
    npzs = sorted(
        os.path.join(folder, f) for f in os.listdir(folder)
        if f.endswith(".npz") and not f.endswith(".props.npz")
    )
    if num_processes <= 1 or len(npzs) <= 1:
        for f in npzs:
            _unpack_case(f)
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=num_processes, mp_context=ctx) as ex:
            list(ex.map(_unpack_case, npzs))


class CaseDataset:
    """key -> (data (c,x,y,z), seg (1,x,y,z), properties). Prefers mmap .npy.
    With `folder_with_segs_from_previous_stage`, seg is (2,x,y,z): the labels,
    then the previous stage's segmentation (`<key>.npz["seg"]` there)."""

    def __init__(self, folder: str, case_identifiers: Optional[List[str]] = None,
                 folder_with_segs_from_previous_stage: Optional[str] = None):
        self.folder = folder
        if case_identifiers is None:
            case_identifiers = sorted({
                f[:-4] for f in os.listdir(folder)
                if f.endswith(".npz") and not f.endswith(".props.npz")
            })
        self.dataset: Dict[str, dict] = {
            k: {
                "data_file": os.path.join(folder, k + ".npz"),
                "properties_file": os.path.join(folder, k),
            }
            for k in case_identifiers
        }
        self.folder_with_segs_from_previous_stage = folder_with_segs_from_previous_stage

    def keys(self):
        return self.dataset.keys()

    def __len__(self):
        return len(self.dataset)

    def case_shape(self, key: str) -> Tuple[int, ...]:
        """(c, x, y, z) of the preprocessed data WITHOUT loading it: reads
        only the .npy header (or the npz member's header), so that the device
        cache can survey every case's shape at startup."""
        def _header_shape(f):
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            else:
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            return shape

        entry = self.dataset[key]
        base = entry["data_file"][:-4]
        if os.path.isfile(base + ".npy"):
            with open(base + ".npy", "rb") as f:
                return _header_shape(f)
        import zipfile
        with zipfile.ZipFile(entry["data_file"]) as z:
            with z.open("data.npy") as f:
                return _header_shape(f)

    def load_case(self, key: str) -> Tuple[np.ndarray, np.ndarray, dict]:
        entry = self.dataset[key]
        base = entry["data_file"][:-4]
        data = seg = None
        if os.path.isfile(base + ".npy"):
            data = np.load(base + ".npy", mmap_mode="r")
        if os.path.isfile(base + "_seg.npy"):
            seg = np.load(base + "_seg.npy", mmap_mode="r")
        if data is None or seg is None:
            with np.load(entry["data_file"]) as z:
                if data is None:
                    data = z["data"]
                if seg is None:
                    seg = z["seg"]
        if self.folder_with_segs_from_previous_stage is not None:
            ps_file = os.path.join(self.folder_with_segs_from_previous_stage, key + ".npz")
            seg_prev = np.load(ps_file)["seg"]
            seg = np.vstack([np.asarray(seg), seg_prev[None] if seg_prev.ndim == 3 else seg_prev])
        return data, seg, load_properties(entry["properties_file"])

"""Case properties on disk. The port's own copy of `save_properties` and
`load_properties` of anatomask_tpu/preprocessing/preprocessor.py, which the
data path reads; the preprocessor itself is not ported yet (ROADMAP.md)."""
from __future__ import annotations

import json
import os
import pickle

import numpy as np


def save_properties(properties: dict, output_filename_truncated: str):
    """Store case properties as JSON + an npz for array-valued class_locations."""
    props = dict(properties)
    class_locs = props.pop("class_locations", None)
    props.pop("nifti_header", None)
    props.pop("affine", None)
    serializable = {}
    for k, v in props.items():
        if isinstance(v, np.ndarray):
            v = v.tolist()
        serializable[k] = v
    arrays = {}
    if "nifti_header" in properties:
        arrays["nifti_header"] = np.frombuffer(properties["nifti_header"], dtype=np.uint8)
    if "affine" in properties:
        arrays["affine"] = np.asarray(properties["affine"])
    if class_locs is not None:
        keys = []
        for i, (k, v) in enumerate(class_locs.items()):
            keys.append(repr(k))
            arrays[f"class_loc_{i}"] = np.asarray(v, dtype=np.int32)
        serializable["__class_location_keys__"] = keys
    with open(output_filename_truncated + ".props.json", "w") as f:
        json.dump(serializable, f)
    if arrays:
        np.savez_compressed(output_filename_truncated + ".props.npz", **arrays)


def load_properties(output_filename_truncated: str) -> dict:
    """Load properties written by save_properties, or a reference .pkl file."""
    jpath = output_filename_truncated + ".props.json"
    if not os.path.isfile(jpath):
        # fall back to nnU-Net reference pickle format
        with open(output_filename_truncated + ".pkl", "rb") as f:
            return pickle.load(f)
    with open(jpath) as f:
        props = json.load(f)
    npz_path = output_filename_truncated + ".props.npz"
    if os.path.isfile(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            if "nifti_header" in z:
                props["nifti_header"] = z["nifti_header"].tobytes()
            if "affine" in z:
                props["affine"] = z["affine"]
            keys = props.pop("__class_location_keys__", None)
            if keys is not None:
                from ast import literal_eval
                props["class_locations"] = {
                    literal_eval(k): z[f"class_loc_{i}"] for i, k in enumerate(keys)
                }
    return props

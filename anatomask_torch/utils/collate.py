"""Output collation helper.

After nnU-Net's nnunetv2/utilities/collate_outputs.py:6 —
merge a list of per-step dicts into one dict: numpy arrays stacked/averaged
downstream, scalars listed.

Counterpart of anatomask_tpu/utils/collate.py, copied function for function.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def collate_outputs(outputs: List[dict]) -> Dict[str, np.ndarray]:
    collated: Dict[str, np.ndarray] = {}
    for k in outputs[0].keys():
        vals = [o[k] for o in outputs]
        if np.isscalar(vals[0]):
            collated[k] = np.asarray(vals)
        elif isinstance(vals[0], np.ndarray):
            collated[k] = np.vstack([v[None] for v in vals])
        else:
            raise ValueError(f"cannot collate entries of type {type(vals[0])} for key {k!r}")
    return collated

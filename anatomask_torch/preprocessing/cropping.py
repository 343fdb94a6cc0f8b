"""Crop-to-nonzero: the port's own copy of
anatomask_tpu/preprocessing/cropping.py (nnU-Net's cropping.py).

The nonzero mask is the union over channels of (data != 0) with holes
filled; the volume is cropped to the mask's bounding box; voxels outside the
mask that are background (seg == 0) are relabeled -1 so that masked
normalization and the 'outside region' convention survive downstream.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.ndimage import binary_fill_holes


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """data: (c, x, y, z) -> bool mask (x, y, z) of any-channel-nonzero, holes filled."""
    assert data.ndim == 4, "data must be (c, x, y, z)"
    nonzero_mask = (data != 0).any(axis=0)
    return binary_fill_holes(nonzero_mask)


def get_bbox_from_mask(mask: np.ndarray) -> List[List[int]]:
    """Bounding box [[lo, hi), ...] per axis of the True region."""
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        any_ax = mask.any(axis=other)
        idx = np.where(any_ax)[0]
        if len(idx) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(idx[0]), int(idx[-1]) + 1])
    return bbox


def bounding_box_to_slice(bbox: List[List[int]]) -> Tuple[slice, ...]:
    return tuple(slice(int(lo), int(hi)) for lo, hi in bbox)


def crop_to_nonzero(
    data: np.ndarray, seg: Optional[np.ndarray] = None, nonzero_label: int = -1
) -> Tuple[np.ndarray, np.ndarray, List[List[int]]]:
    """Crop (c, x, y, z) data (and optional (1, x, y, z) seg) to the nonzero bbox.

    Returns (cropped data, seg with outside-mask background set to nonzero_label,
    bbox). If seg is None, a seg volume is created holding only {0, nonzero_label}.
    """
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask)
    slicer = bounding_box_to_slice(bbox)

    data = data[(slice(None), *slicer)]
    nonzero_mask = nonzero_mask[slicer][None]
    if seg is not None:
        seg = seg[(slice(None), *slicer)]
        seg[(seg == 0) & ~nonzero_mask] = nonzero_label
    else:
        seg = np.where(nonzero_mask, np.int8(0), np.int8(nonzero_label))
    return data, seg, bbox

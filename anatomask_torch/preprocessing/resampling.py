"""Resampling with nnU-Net's semantics: the port's own copy of
anatomask_tpu/preprocessing/resampling.py, host numpy with the same fp64
arithmetic.

Cubic-spline resize for data, per-label thresholded resize for
segmentations, and the anisotropic "separate z" path (in-plane spline +
low-order interpolation along the low-resolution axis when
max(spacing)/min(spacing) > ANISO_THRESHOLD).

Implementation: nnU-Net evaluates an N-D spline warp over a dense coordinate
grid (skimage.resize / scipy.map_coordinates). Grid-aligned resampling is a
tensor product, so a dense 1-D interpolation matrix per axis (spline
prefilter + B-spline evaluation at (i+0.5)*old/new-0.5 with edge handling,
skimage's mode='edge', anti_aliasing=False convention) is applied as a
matmul. Identical numerics, no (3, x, y, z) coordinate tensor.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
from scipy.ndimage import map_coordinates

from anatomask_torch.configuration import ANISO_THRESHOLD


def get_do_separate_z(spacing, anisotropy_threshold=ANISO_THRESHOLD) -> bool:
    spacing = np.asarray(spacing, dtype=float)
    return bool((spacing.max() / spacing.min()) > anisotropy_threshold)


def get_lowres_axis(new_spacing) -> np.ndarray:
    new_spacing = np.asarray(new_spacing, dtype=float)
    return np.where(max(new_spacing) / new_spacing == 1)[0]


def compute_new_shape(old_shape, old_spacing, new_spacing) -> np.ndarray:
    assert len(old_spacing) == len(old_shape) == len(new_spacing)
    return np.array([int(round(i / j * k)) for i, j, k in zip(old_spacing, new_spacing, old_shape)])


@lru_cache(maxsize=256)
def _interp_matrix(n_in: int, n_out: int, order: int) -> np.ndarray:
    """(n_out, n_in) matrix evaluating an order-`order` spline (with prefilter,
    edge/'nearest' boundary) of a length-n_in signal at skimage-resize sample
    positions (i+0.5)*n_in/n_out - 0.5."""
    coords = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    W = np.empty((n_out, n_in), dtype=np.float64)
    basis = np.zeros(n_in, dtype=np.float64)
    for j in range(n_in):
        basis[j] = 1.0
        W[:, j] = map_coordinates(basis, coords[None], order=order, mode="nearest")
        basis[j] = 0.0
    return W


def _resize_axis(data: np.ndarray, axis: int, n_out: int, order: int) -> np.ndarray:
    n_in = data.shape[axis]
    if n_in == n_out:
        return data
    W = _interp_matrix(n_in, n_out, order)
    moved = np.moveaxis(data, axis, -1)
    out = moved @ W.T.astype(moved.dtype, copy=False)
    return np.moveaxis(out, -1, axis)


def _resize_volume(vol: np.ndarray, new_shape, orders: Tuple[int, ...]) -> np.ndarray:
    """Resize (x, y, z) float volume with a per-axis spline order."""
    out = vol.astype(np.float64, copy=False)
    for ax, (n_out, order) in enumerate(zip(new_shape, orders)):
        out = _resize_axis(out, ax, int(n_out), order)
    return out


def _resize_seg_volume(seg: np.ndarray, new_shape, orders: Tuple[int, ...]) -> np.ndarray:
    """Per-label thresholded resize (reference resize_segmentation semantics):
    each label's indicator is spline-resized and voxels with value > 0.5 painted
    in ascending label order. Pure nearest (all orders 0) short-circuits."""
    if all(o == 0 for o in orders):
        return _resize_volume(seg.astype(np.float64), new_shape, orders).astype(seg.dtype)
    unique_labels = np.sort(np.unique(seg))
    out = np.zeros(tuple(int(s) for s in new_shape), dtype=seg.dtype)
    for cl in unique_labels:
        indicator = _resize_volume((seg == cl).astype(np.float64), new_shape, orders)
        out[indicator > 0.5] = cl
    return out


def resample_data_or_seg(
    data: np.ndarray,
    new_shape,
    is_seg: bool = False,
    axis: Optional[np.ndarray] = None,
    order: int = 3,
    do_separate_z: bool = False,
    order_z: int = 0,
) -> np.ndarray:
    """data: (c, x, y, z). Matches reference resample_data_or_seg (:125)."""
    assert data.ndim == 4, "data must be (c, x, y, z)"
    assert len(new_shape) == data.ndim - 1
    shape = np.array(data.shape[1:])
    new_shape = np.array([int(i) for i in new_shape])
    if np.all(shape == new_shape):
        return data
    dtype_data = data.dtype

    orders = [order, order, order]
    if do_separate_z:
        assert axis is not None and len(axis) == 1, "only one anisotropic axis supported"
        orders[int(axis[0])] = order_z

    out = np.empty((data.shape[0], *new_shape), dtype=dtype_data)
    for c in range(data.shape[0]):
        if is_seg:
            out[c] = _resize_seg_volume(data[c], new_shape, tuple(orders))
        else:
            out[c] = _resize_volume(data[c].astype(np.float64), new_shape, tuple(orders)).astype(dtype_data)
    return out


def _determine_axis(current_spacing, new_spacing, force_separate_z, threshold):
    if force_separate_z is not None:
        do_separate_z = force_separate_z
        axis = get_lowres_axis(current_spacing) if force_separate_z else None
    else:
        if get_do_separate_z(current_spacing, threshold):
            do_separate_z, axis = True, get_lowres_axis(current_spacing)
        elif get_do_separate_z(new_spacing, threshold):
            do_separate_z, axis = True, get_lowres_axis(new_spacing)
        else:
            do_separate_z, axis = False, None
    if axis is not None and len(axis) != 1:
        # 2 or 3 equal-lowres axes -> plain 3D resampling (reference behavior)
        do_separate_z, axis = False, None
    return do_separate_z, axis


def resample_data_or_seg_to_shape(
    data: np.ndarray,
    new_shape,
    current_spacing,
    new_spacing,
    is_seg: bool = False,
    order: int = 3,
    order_z: int = 0,
    force_separate_z: Union[bool, None] = False,
    separate_z_anisotropy_threshold: float = ANISO_THRESHOLD,
) -> np.ndarray:
    do_separate_z, axis = _determine_axis(
        current_spacing, new_spacing, force_separate_z, separate_z_anisotropy_threshold
    )
    return resample_data_or_seg(
        np.asarray(data), new_shape, is_seg, axis, order, do_separate_z, order_z=order_z
    )


def resample_data_or_seg_to_spacing(
    data: np.ndarray,
    current_spacing,
    new_spacing,
    is_seg: bool = False,
    order: int = 3,
    order_z: int = 0,
    force_separate_z: Union[bool, None] = False,
    separate_z_anisotropy_threshold: float = ANISO_THRESHOLD,
) -> np.ndarray:
    new_shape = compute_new_shape(np.asarray(data[0].shape), current_spacing, new_spacing)
    return resample_data_or_seg_to_shape(
        data, new_shape, current_spacing, new_spacing, is_seg, order, order_z,
        force_separate_z, separate_z_anisotropy_threshold,
    )


_RESAMPLING_FNS = {
    "resample_data_or_seg_to_shape": resample_data_or_seg_to_shape,
    "resample_data_or_seg_to_spacing": resample_data_or_seg_to_spacing,
}


def get_resampling_fn(name: str):
    if name not in _RESAMPLING_FNS:
        raise RuntimeError(f"Unknown resampling fn {name!r}. Known: {sorted(_RESAMPLING_FNS)}")
    return _RESAMPLING_FNS[name]

"""U-Net topology from spacing and patch size. The port's own copy of
anatomask_tpu/planning/topology.py (nnU-Net's network_topology.py).

Every axis whose feature map is still at least twice the minimum edge and
whose spacing is within 2x of the finest is halved, stage after stage; conv
kernels start at 1 along coarse axes and become 3 once the axis spacing is
within 2x of the finest; the patch is padded up to divisibility by the total
pooling factor; the bottleneck gets a 3^d kernel.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def get_shape_must_be_divisible_by(num_pool_per_axis: Sequence[int]) -> np.ndarray:
    return 2 ** np.asarray(num_pool_per_axis)


def pad_shape(shape: Sequence[int], must_be_divisible_by) -> np.ndarray:
    """Smallest shape >= `shape` divisible by `must_be_divisible_by` per axis."""
    if not isinstance(must_be_divisible_by, (tuple, list, np.ndarray)):
        must_be_divisible_by = [must_be_divisible_by] * len(shape)
    assert len(must_be_divisible_by) == len(shape)
    out = []
    for s, m in zip(shape, must_be_divisible_by):
        out.append(int(s) if s % m == 0 else int(s + m - s % m))
    return np.array(out, dtype=int)


def get_pool_and_conv_props(
    spacing: Sequence[float],
    patch_size: Sequence[int],
    min_feature_map_size: int,
    max_numpool: int,
) -> Tuple[List[int], List[List[int]], List[List[int]], np.ndarray, np.ndarray]:
    """Returns (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
    padded_patch_size, shape_must_be_divisible_by)."""
    dim = len(spacing)
    current_spacing = list(map(float, spacing))
    current_size = list(map(float, patch_size))

    pool_op_kernel_sizes: List[List[int]] = [[1] * dim]
    conv_kernel_sizes: List[List[int]] = []
    num_pool_per_axis = [0] * dim
    kernel_size = [1] * dim

    while True:
        # axes still large enough to halve
        valid = [i for i in range(dim) if current_size[i] >= 2 * min_feature_map_size]
        if not valid:
            break
        # only pool axes whose resolution is within 2x of the current finest
        min_sp = min(current_spacing[i] for i in valid)
        valid = [i for i in valid if current_spacing[i] / min_sp < 2]
        valid = [i for i in valid if num_pool_per_axis[i] < max_numpool]
        if len(valid) == 1:
            # a single lonely axis only keeps pooling while it is comfortably large
            if current_size[valid[0]] < 3 * min_feature_map_size:
                break
        if not valid:
            break

        # kernel sizes grow 1 -> 3 for good once the axis is within 2x of the finest
        for d in range(dim):
            if kernel_size[d] != 3 and current_spacing[d] / min(current_spacing) < 2:
                kernel_size[d] = 3

        pool = [1] * dim
        for v in valid:
            pool[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = np.ceil(current_size[v] / 2)
        pool_op_kernel_sizes.append(pool)
        conv_kernel_sizes.append(list(kernel_size))

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    patch_size = pad_shape(patch_size, must_be_divisible_by)
    conv_kernel_sizes.append([3] * dim)  # bottleneck
    return num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, patch_size, must_be_divisible_by

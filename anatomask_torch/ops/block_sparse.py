"""Block-sparse execution for masked (SparK/AnatoMask) encoders.
Counterpart of anatomask_tpu/ops/block_sparse.py.

The student input is zero outside the active patches (at mask ratio 0.6
about 40% of them carry signal). Since the keep-count `len_keep` is fixed,
the K = len_keep active blocks of each sample form a dense batch of static
shape, and the first encoder stages can skip the masked blocks entirely:

- `active_block_indices`: the K active block ids a sample, sorted, with no
  host synchronisation (a stable argsort, not `torch.nonzero`);
- `block_gather` / `block_scatter`: dense NDHWC <-> (B, K, bs, bs, bs, C);
- `neighbor_positions`: a (B, K, 26) table of each block's neighbour's
  position in the active list, K (a zero block) where the neighbour is
  inactive or outside the grid. Column i is direction DIRECTIONS[i], the
  JAX package's (dz, dy, dx) loop order; column 25 - i is its opposite;
- `halo_exchange`: the 1-voxel halo from the neighbours' faces, edges and
  corners. Its backward gathers each face's gradient back through the
  opposite direction's column and adds the 26 directions in DIRECTIONS
  order in fp32, rounding once: no atomics, so two backward passes give the
  same bits;
- `block_conv3`: the VALID 3x3x3 conv of halo'd blocks on kernel #2
  (`ops/zslab_conv.py` `conv3d_zconcat` at padding 0: each first-axis tap's
  sum rounded, the taps added in the compute dtype, as the JAX package's
  `conv3d_zconcat_folded` rounds it at any size); its dx is kernel #1's
  "full" conv (padding 2), rounded once, as jax.vjp's one conv over the
  3F-channel cotangent;
- `block_conv3_s2` and `block_conv1x1`: the stride-2 stage heads and the 1x1
  skips, library calls as in JAX (one `F.conv3d`, one matmul);
- `block_moments`: per-(sample, channel) fp32 mean and variance over the
  block interiors on kernel #3 (`ops/moments.py` `row_moments`, x squared in
  fp32 as JAX's `block_moments` squares it). The blocks cover the active
  voxels disjointly, so these equal the dense masked moments.

Layouts are the JAX package's: activations NDHWC, kernels DHWIO.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as fn

from anatomask_torch.ops.moments import row_moments
from anatomask_torch.ops.zslab_conv import conv3d_zconcat

# the 26 neighbour directions (dz, dy, dx) in the JAX package's loop order;
# the opposite of DIRECTIONS[i] is DIRECTIONS[25 - i]
DIRECTIONS = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                   if (dz, dy, dx) != (0, 0, 0))


def active_block_indices(active: torch.Tensor, len_keep: int) -> torch.Tensor:
    """active (B, ...) bool with len_keep True a sample (any layout of the
    patch grid with singleton axes) -> (B, K) int64 flat block ids, sorted:
    the True entries first, in order, by a stable argsort (no host sync)."""
    flat = active.reshape(active.shape[0], -1)
    order = torch.argsort((~flat).to(torch.uint8), dim=1, stable=True)
    return order[:, :len_keep]


def _batch_index(idx: torch.Tensor) -> torch.Tensor:
    return torch.arange(idx.shape[0], device=idx.device)[:, None]


def block_gather(x: torch.Tensor, idx: torch.Tensor, grid: Tuple[int, int, int],
                 bs: int) -> torch.Tensor:
    """x (B, Z, Y, X, C), idx (B, K) flat active-block ids ->
    (B, K, bs, bs, bs, C)."""
    B, C = x.shape[0], x.shape[-1]
    gz, gy, gx = grid
    xb = x.reshape(B, gz, bs, gy, bs, gx, bs, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    xb = xb.reshape(B, gz * gy * gx, bs, bs, bs, C)
    return xb[_batch_index(idx), idx]


def block_scatter(blocks: torch.Tensor, idx: torch.Tensor, grid: Tuple[int, int, int],
                  bs: int) -> torch.Tensor:
    """Inverse of block_gather: (B, Z, Y, X, C), inactive blocks zero."""
    B, C = blocks.shape[0], blocks.shape[-1]
    gz, gy, gx = grid
    dense = blocks.new_zeros((B, gz * gy * gx, bs, bs, bs, C))
    dense = dense.index_put((_batch_index(idx), idx), blocks)
    dense = dense.reshape(B, gz, gy, gx, bs, bs, bs, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return dense.reshape(B, gz * bs, gy * bs, gx * bs, C)


def neighbor_positions(idx: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    """idx (B, K) -> (B, K, 26) int64: column i holds the position in the
    active list of each block's neighbour in direction DIRECTIONS[i], K where
    that neighbour is inactive or outside the grid."""
    B, K = idx.shape
    gz, gy, gx = grid
    n = gz * gy * gx
    inv = torch.full((B, n + 1), K, dtype=torch.int64, device=idx.device)
    inv.scatter_(1, idx, torch.arange(K, device=idx.device).expand(B, K))
    # the 26 directions at once, made on the device (a host list would be
    # copied over, which waits for the stream); direction t of the 27 in
    # (dz, dy, dx) order is t // 9 - 1, t // 3 % 3 - 1, t % 3 - 1, minus t = 13
    t = torch.arange(26, device=idx.device)
    t = t + (t >= 13)
    nz = (idx // (gy * gx))[:, :, None] + t // 9 - 1
    ny = ((idx // gx) % gy)[:, :, None] + t // 3 % 3 - 1
    nx = (idx % gx)[:, :, None] + t % 3 - 1
    inside = (nz >= 0) & (nz < gz) & (ny >= 0) & (ny < gy) & (nx >= 0) & (nx < gx)
    flat = torch.where(inside, (nz * gy + ny) * gx + nx, n)
    return torch.gather(inv, 1, flat.reshape(B, K * 26)).reshape(B, K, 26)


def _src(d: int, bs: int) -> slice:
    """The face of a neighbour that direction d's halo reads."""
    return slice(0, 1) if d == 1 else slice(bs - 1, bs) if d == -1 else slice(0, bs)


def _dst(d: int, bs: int) -> slice:
    """Direction d's part of the halo'd block."""
    return slice(bs + 1, bs + 2) if d == 1 else slice(0, 1) if d == -1 else slice(1, bs + 1)


def _with_zero_block(t: torch.Tensor) -> torch.Tensor:
    """(B, K, ...) -> (B, K + 1, ...), block K zeros: what a neighbour
    position K reads."""
    return torch.cat([t, t.new_zeros((t.shape[0], 1, *t.shape[2:]))], 1)


class HaloExchangeFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blocks, nb):
        ctx.save_for_backward(nb)
        B, K, bs, C = blocks.shape[0], blocks.shape[1], blocks.shape[2], blocks.shape[-1]
        b, src = _batch_index(nb), _with_zero_block(blocks)
        # the interior and the 26 directions' parts cover the halo'd block once
        out = blocks.new_empty((B, K, bs + 2, bs + 2, bs + 2, C))
        out[:, :, 1:bs + 1, 1:bs + 1, 1:bs + 1] = blocks
        for i, (dz, dy, dx) in enumerate(DIRECTIONS):
            face = src[:, :, _src(dz, bs), _src(dy, bs), _src(dx, bs)]
            out[:, :, _dst(dz, bs), _dst(dy, bs), _dst(dx, bs)] = face[b, nb[:, :, i]]
        return out

    @staticmethod
    def backward(ctx, g):
        nb, = ctx.saved_tensors
        bs = g.shape[2] - 2
        b, gz = _batch_index(nb), _with_zero_block(g)
        acc = g[:, :, 1:bs + 1, 1:bs + 1, 1:bs + 1].to(torch.float32, copy=True)
        for i, (dz, dy, dx) in enumerate(DIRECTIONS):
            # block j's face fed the halo of its neighbour in the opposite direction
            part = gz[:, :, _dst(dz, bs), _dst(dy, bs), _dst(dx, bs)]
            acc[:, :, _src(dz, bs), _src(dy, bs), _src(dx, bs)] += part[b, nb[:, :, 25 - i]]
        return acc.to(g.dtype), None


def halo_exchange(blocks: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """(B, K, bs, bs, bs, C) -> (B, K, bs+2, bs+2, bs+2, C): the 1-voxel halo
    filled from the neighbours of `nb` (zeros where a neighbour is
    inactive). Differentiable in blocks, deterministically."""
    return HaloExchangeFunction.apply(blocks, nb)


def block_conv3(blocks: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """VALID 3x3x3 conv of halo'd (B, K, e, e, e, C) blocks, kernel (3, 3, 3,
    C, F) -> (B, K, e-2, e-2, e-2, F): kernel #2 at padding 0 (per-tap
    rounding), dx kernel #1 at padding 2."""
    B, K, e, C = blocks.shape[0], blocks.shape[1], blocks.shape[2], blocks.shape[-1]
    y = conv3d_zconcat(blocks.reshape(B * K, e, e, e, C).contiguous(), kernel, 0)
    return y.reshape(B, K, *y.shape[1:])


def block_conv3_s2(blocks: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Stride-2 VALID 3x3x3 conv of halo'd (B, K, e, e, e, C) blocks (e = bs +
    2) -> (B, K, bs/2, bs/2, bs/2, F): output voxel o reads halo'd
    coordinates 2o .. 2o + 2, i.e. block coordinates 2o - 1 .. 2o + 1, the
    stage head's padded stride-2 conv restricted to the block. One F.conv3d,
    rounded once, as JAX's lax.conv_general_dilated."""
    B, K, e, C = blocks.shape[0], blocks.shape[1], blocks.shape[2], blocks.shape[-1]
    x5 = blocks.reshape(B * K, e, e, e, C).permute(0, 4, 1, 2, 3)
    y = fn.conv3d(x5, kernel.to(blocks.dtype).permute(4, 3, 0, 1, 2), None, 2)
    y = y.permute(0, 2, 3, 4, 1).contiguous()
    return y.reshape(B, K, *y.shape[1:])


def block_conv1x1(blocks: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """1x1x1 conv (a matmul) of (B, K, bs, bs, bs, C) blocks, kernel (1, 1, 1,
    C, F); stride 2 keeps voxels 0, 2, 4, ... as torch's k1 s2 conv does."""
    if stride == 2:
        blocks = blocks[:, :, ::2, ::2, ::2]
    return blocks @ kernel.reshape(kernel.shape[-2], kernel.shape[-1]).to(blocks.dtype)


def block_moments(blocks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, var), each (B, C), over every voxel of the (B, K, bs, bs,
    bs, C) blocks: kernel #3's sums with x squared in fp32."""
    B, K, bs, C = blocks.shape[0], blocks.shape[1], blocks.shape[2], blocks.shape[-1]
    s, ss = row_moments(blocks.reshape(B, K * bs, bs, bs, C).contiguous())
    n = float(K * bs ** 3)
    mean = s / n
    return mean, (ss / n - mean * mean).clamp_min(0.0)

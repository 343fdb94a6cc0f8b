"""Masked ("sparse") 3D layers for SparK-style pretraining. Counterpart of
anatomask_tpu/ssl/sparse.py, with its opt-in block-sparse route.

The mask is passed explicitly to every layer as (B, 1, f1, f2, f3) bool,
True = visible, and dilated to any resolution by integer repeats (the
reference's repeat_interleave). Norms compute their statistics over the
visible voxels only and zero the rest. Module and parameter names follow the
reference torch STUNet head (`conv_blocks_context.{stage}.{block}.conv1...`).

- the STUNet encoder: `SparseBasicResBlock`, `_SparseResStage` (depth
  blocks, the first strided with the 1x1 skip), `SparseSTUNetEncoder`, with
  activation checkpointing a stage where `remat` (the JAX package's
  `nn.remat(_SparseResStage)`);
- the block-sparse route (`ATK_BLOCK_SPARSE=1`, the first
  `ATK_BLOCK_SPARSE_STAGES` stages, default 2, read at each forward as JAX
  reads them at trace time): the encoder gathers the `len_keep` active
  blocks of each sample once (`ops/block_sparse.py`) and runs those stages
  on them alone with `SparseBasicResBlock.forward_blocks`, JAX's
  `BlockSparseResBlock` over the same parameters, scattering each stage's
  output to a dense feature; `block_stage_count` holds JAX's rules for when
  it applies;
- norms: `SparseInstanceNorm` and `SparseBatchNorm` on the moments kernel's
  per-row sums (kernel #3), `SparseLayerNorm` and `SparseGroupNorm` in plain
  torch (JAX computes them outside any Pallas kernel);
- `sparse_masked_global_pool`, `sparse_max_pool`, `sparse_avg_pool`, `GRN`,
  `SparseGRN` and `SparseConvNeXtBlock` (its depthwise conv `F.conv3d`).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as fn

from anatomask_torch.models.layers import CL3D, ConvND, leaky_relu, run_remat, trunc_normal_
from anatomask_torch.ops.block_sparse import (active_block_indices, block_conv1x1, block_conv3,
                                              block_conv3_s2, block_gather, block_moments,
                                              block_scatter, halo_exchange, neighbor_positions)
from anatomask_torch.ops.moments import row_moments
from anatomask_torch.parallel import mesh


def upsample_mask(mask: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """(B, 1, f1, f2, f3) -> (B, 1, f1*k1, f2*k2, f3*k3) by repeats."""
    for ax, k in enumerate(factors):
        if k != 1:
            mask = mask.repeat_interleave(int(k), dim=ax + 2)
    return mask


def mask_to_resolution(mask: torch.Tensor, spatial_shape: Sequence[int]) -> torch.Tensor:
    """Dilate the feature-grid mask to an integer multiple of its resolution."""
    grid = mask.shape[2:5]
    factors = [int(s) // int(m) for s, m in zip(spatial_shape, grid)]
    if any(f < 1 or s != f * m for f, s, m in zip(factors, spatial_shape, grid)):
        raise ValueError(f"resolution {tuple(spatial_shape)} is not an integer multiple "
                         f"of mask grid {tuple(grid)}")
    return upsample_mask(mask, factors)


def _masked_moments(x: torch.Tensor, m: torch.Tensor, batch_pooled: bool):
    """fp32 mean/var per (sample, channel) over the visible voxels (m == 1),
    (B, C, 1, 1, 1); pooled over the batch as (1, C, 1, 1, 1), and then over
    the ranks of a process group (the global batch's visible voxels, as JAX's
    program over the sharded batch pools them). The sums come from the
    moments kernel, x*x squared in x's dtype as JAX's `_masked_moments`
    squares it; counts are clamped >= 1."""
    x = x.contiguous(memory_format=CL3D)
    s, ss = row_moments(x.permute(0, 2, 3, 4, 1), m[:, 0], square_in_dtype=True)
    cnt = m.sum((1, 2, 3, 4), dtype=torch.float32)[:, None]
    if batch_pooled:
        s, ss, cnt = s.sum(0, keepdim=True), ss.sum(0, keepdim=True), cnt.sum(0, keepdim=True)
        if mesh.distributed():
            C = s.shape[1]
            s, ss, cnt = mesh.all_reduce_sum(torch.cat([s, ss, cnt], 1)).split([C, C, 1], 1)
    cnt = cnt.clamp_min(1.0)
    mean = s / cnt
    var = (ss / cnt - mean.square()).clamp_min(0.0)
    return mean[:, :, None, None, None], var[:, :, None, None, None]


class SparseInstanceNorm(nn.Module):
    """InstanceNorm over visible voxels only, zeros elsewhere. The default is
    the per-sample law; batch_pooled=True pools the statistics over the whole
    batch's visible voxels (the reference's B>1 law)."""

    def __init__(self, channels: int, eps: float = 1e-5, batch_pooled: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.batch_pooled, self.dtype = eps, batch_pooled, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        m = mask_to_resolution(active, x.shape[2:5])
        mean, var = _masked_moments(x, m, self.batch_pooled)
        scale = self.weight.view(1, -1, 1, 1, 1)
        a = torch.rsqrt(var + self.eps)
        b = -mean * a * scale + self.bias.view(1, -1, 1, 1, 1)
        a = a * scale
        dt = self.dtype
        return (x.to(dt) * a.to(dt) + b.to(dt)) * m.to(dt)


class SparseBatchNorm(SparseInstanceNorm):
    """BatchNorm over the visible voxels of the whole batch (the reference's
    SparseBatchNorm3d), eps 1e-5: the batch-pooled statistics of
    SparseInstanceNorm. No running statistics: no configuration of the
    pretraining path keeps them (the JAX package's PretrainConfig builds its
    SparseBatchNorm without track_running_stats)."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__(channels, eps, batch_pooled=True, dtype=dtype)


class SparseGroupNorm(nn.Module):
    """GroupNorm over the visible voxels (the reference's SparseGroupNorm), its
    fp32 variance in two passes, E[(x - mean)^2]; zeros elsewhere."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        g = self.num_groups
        m = mask_to_resolution(active, x.shape[2:5]).float()
        xf = x.float().reshape(B, g, C // g, *x.shape[2:])
        mg = m[:, :, None]
        cnt = (m.sum((1, 2, 3, 4)) * (C // g)).clamp_min(1.0).view(B, 1, 1, 1, 1, 1)
        mean = (xf * mg).sum((2, 3, 4, 5), keepdim=True) / cnt
        var = ((xf - mean).square() * mg).sum((2, 3, 4, 5), keepdim=True) / cnt
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight.view(1, -1, 1, 1, 1) + self.bias.view(1, -1, 1, 1, 1)
        return (y * m).to(self.dtype)


class SparseLayerNorm(nn.Module):
    """LayerNorm over the channels of each visible voxel (the reference's
    SparseConvNeXtLayerNorm), fp32, eps 1e-6; zeros elsewhere."""

    def __init__(self, channels: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        m = mask_to_resolution(active, x.shape[2:5]).float()
        xf = x.float()
        mean = xf.mean(1, keepdim=True)
        var = xf.var(1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.view(1, -1, 1, 1, 1) + self.bias.view(1, -1, 1, 1, 1)
        return (y * m).to(self.dtype)


def sparse_masked_global_pool(x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Mean over the visible voxels, (B, C, 1, 1, 1) (the reference's
    SparseAdaptiveAvgPooling)."""
    m = mask_to_resolution(active, x.shape[2:5]).to(x.dtype)
    return (x * m).sum((2, 3, 4), keepdim=True) / (m.sum((2, 3, 4), keepdim=True) + 1e-6)


def _strides(window: Sequence[int], strides: Optional[Sequence[int]]) -> Tuple[int, ...]:
    return tuple(strides) if strides is not None else tuple(window)


def sparse_max_pool(x: torch.Tensor, active: torch.Tensor, window: Sequence[int],
                    strides: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Dense max pool (no padding), re-masked at the output's resolution."""
    y = fn.max_pool3d(x, tuple(window), _strides(window, strides))
    return y * mask_to_resolution(active, y.shape[2:5]).to(y.dtype)


def sparse_avg_pool(x: torch.Tensor, active: torch.Tensor, window: Sequence[int],
                    strides: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Dense average pool (no padding), re-masked at the output's resolution."""
    y = fn.avg_pool3d(x, tuple(window), _strides(window, strides))
    return y * mask_to_resolution(active, y.shape[2:5]).to(y.dtype)


def _grn(x: torch.Tensor, sq: torch.Tensor, gamma: torch.Tensor,
         beta: Optional[torch.Tensor]) -> torch.Tensor:
    """(gamma * Nx + 1) * x (+ beta) in fp32 for fp32 x and its square sq:
    Nx = Gx / mean_c(Gx), Gx the spatial L2 norm of each (sample, channel)."""
    gx = sq.sum((2, 3, 4), keepdim=True).sqrt()
    nx = gx / (gx.mean(1, keepdim=True) + 1e-6)
    out = (gamma.float().view(1, -1, 1, 1, 1) * nx + 1.0) * x
    return out if beta is None else out + beta.view(1, -1, 1, 1, 1)


class GRN(nn.Module):
    """ConvNeXt-V2's Global Response Normalization, x squared in its dtype and
    the rest in fp32; gamma and beta start at 0."""

    def __init__(self, channels: int, use_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.zeros(channels))
        self.beta = nn.Parameter(torch.zeros(channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _grn(x.float(), x.square().float(), self.gamma, self.beta).to(self.dtype)


class SparseGRN(GRN):
    """GRN with its spatial statistic over the visible voxels and the output
    re-masked (the dense GRN's law on the visible set)."""

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        m = mask_to_resolution(active, x.shape[2:5]).float()
        xf = x.float() * m
        return (_grn(xf, xf.square(), self.gamma, self.beta) * m).to(self.dtype)


class SparseConvNeXtBlock(nn.Module):
    """Masked ConvNeXt block (the reference's SparseConvNeXtBlock): depthwise
    k x k x k conv (re-masked), SparseLayerNorm, pointwise MLP (4x, GELU in
    its tanh form, flax's default), layer scale gamma, re-mask, stochastic
    depth outside `deterministic`, residual."""

    def __init__(self, dim: int, kernel_size: int = 7, layer_scale_init_value: float = 1e-6,
                 drop_path: float = 0.0, deterministic: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop_path, self.deterministic, self.dtype = drop_path, deterministic, dtype
        self.dwconv = ConvND(dim, dim, kernel_size, groups=dim, dtype=dtype, init="trunc",
                             generator=generator)
        self.norm = SparseLayerNorm(dim, dtype=dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)
        with torch.no_grad():
            for layer in (self.pwconv1, self.pwconv2):
                trunc_normal_(layer.weight, generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.dwconv(x)
        m = mask_to_resolution(active, y.shape[2:5]).to(y.dtype)
        y = self.norm(y * m, active).permute(0, 2, 3, 4, 1)
        y = fn.gelu(fn.linear(y, self.pwconv1.weight.to(dt), self.pwconv1.bias.to(dt)),
                    approximate="tanh")
        y = fn.linear(y, self.pwconv2.weight.to(dt), self.pwconv2.bias.to(dt))
        if self.gamma is not None:
            y = y * self.gamma.to(y.dtype)
        y = y.permute(0, 4, 1, 2, 3) * m
        if self.drop_path > 0 and not self.deterministic:
            keep = 1.0 - self.drop_path
            y = y * torch.bernoulli(torch.full((y.shape[0], 1, 1, 1, 1), keep,
                                               device=y.device)).to(y.dtype) / keep
        return x + y


class SparseBasicResBlock(nn.Module):
    """Masked residual block: conv1 (stride s) -> IN -> LeakyReLU -> conv2 ->
    IN, plus a 1x1 conv3 (stride s) on the skip, summed and LeakyReLU'd.

    Masking invariant: the block input is zero outside the visible voxels and
    so is its output. The masked norms weight their statistics by the mask and
    zero their output, so only the 1x1 skip needs an explicit re-mask."""

    def __init__(self, cin: int, cout: int, stride: int = 1, use_1x1conv: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, batch_pooled: bool = False):
        super().__init__()
        dd = dict(dtype=dtype, generator=generator)
        self.dtype = dtype
        self.conv1 = ConvND(cin, cout, 3, stride, **dd)
        self.norm1 = SparseInstanceNorm(cout, batch_pooled=batch_pooled, dtype=dtype)
        self.conv2 = ConvND(cout, cout, 3, 1, **dd)
        self.norm2 = SparseInstanceNorm(cout, batch_pooled=batch_pooled, dtype=dtype)
        self.conv3 = ConvND(cin, cout, 1, stride, **dd) if use_1x1conv else None

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.norm1(self.conv1(x), active))
        y = self.norm2(self.conv2(y), active)
        if self.conv3 is not None:
            x = self.conv3(x)
            x = x * mask_to_resolution(active, x.shape[2:5]).to(self.dtype)
        return leaky_relu(y + x)

    def forward_blocks(self, x: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
        """The same block on active-block layout (the JAX package's
        BlockSparseResBlock): x (B, K, bs, bs, bs, C) -> (B, K, bs', bs', bs',
        F), bs' = bs / stride, halos from the neighbour table `nb`. Every
        voxel of a block is visible, so nothing is re-masked."""
        dt = self.dtype
        x = x.to(dt)
        conv3 = block_conv3 if self.conv1.stride[0] == 1 else block_conv3_s2
        y = conv3(halo_exchange(x, nb), _dhwio(self.conv1)) + self.conv1.bias.to(dt)
        y = leaky_relu(_block_instance_norm(y, self.norm1))
        y = block_conv3(halo_exchange(y, nb), _dhwio(self.conv2)) + self.conv2.bias.to(dt)
        y = _block_instance_norm(y, self.norm2)
        if self.conv3 is not None:
            x = block_conv1x1(x, _dhwio(self.conv3), self.conv3.stride[0])
            x = x + self.conv3.bias.to(dt)
        return leaky_relu(y + x)


def _dhwio(conv: ConvND) -> torch.Tensor:
    """A ConvND's (F, C, kz, ky, kx) weight as the compute dtype's DHWIO."""
    return conv.weight.to(conv.dtype).permute(2, 3, 4, 1, 0)


def _block_instance_norm(blocks: torch.Tensor, norm: SparseInstanceNorm) -> torch.Tensor:
    """SparseInstanceNorm on (B, K, bs, bs, bs, C) active blocks, rounded as
    the JAX package's `_block_instance_norm`: fp32 moments of the block
    interiors (x squared in fp32), a = rsqrt(var + eps) * scale and b = bias -
    mean * a in fp32, then x * a + b in the compute dtype."""
    mean, var = block_moments(blocks)
    a = torch.rsqrt(var + norm.eps) * norm.weight.float()
    b = norm.bias.float() - mean * a
    dt = norm.dtype
    return blocks.to(dt) * a.to(dt)[:, None, None, None, None] + b.to(dt)[:, None, None, None, None]


class _SparseResStage(nn.ModuleList):
    """One encoder stage: `depth` blocks, the first strided with the 1x1 skip.
    A list, so that parameter names keep the reference's block index."""

    def __init__(self, cin: int, cout: int, depth: int, stride: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator], batch_pooled: bool = False):
        dd = dict(dtype=dtype, generator=generator, batch_pooled=batch_pooled)
        super().__init__([SparseBasicResBlock(cin, cout, stride, use_1x1conv=True, **dd)]
                         + [SparseBasicResBlock(cout, cout, 1, **dd) for _ in range(1, depth)])

    def forward(self, x: torch.Tensor, active: torch.Tensor,
                nb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Dense-masked x (B, C, X, Y, Z), or with the neighbour table `nb`
        active blocks (B, K, bs, bs, bs, C)."""
        for block in self:
            x = block(x, active) if nb is None else block.forward_blocks(x, nb)
        return x


def block_stage_count(in_shape: Sequence[int], grid: Sequence[int],
                      strides: Sequence[Sequence[int]], kernels: Sequence[Sequence[int]],
                      len_keep: Optional[int], norm_batch_pooled: bool) -> int:
    """How many leading stages run block-sparse (0: none), by the JAX
    package's `SparseSTUNetEncoder._block_stage_count`: ATK_BLOCK_SPARSE=1,
    a static keep-count, per-sample norms, cubic blocks with the patch grid
    dividing the input, stage 0 at stride 1, stride-2 cubic downsampling
    after, 3x3x3 kernels, blocks that stay >= 4 voxels, and at most
    ATK_BLOCK_SPARSE_STAGES (default 2) stages. Both variables are read at
    each call. `strides` and `kernels` (per stage) keep JAX's rules whole so
    that they can be held against JAX's over its stride tables; the port's
    encoder always passes stride 1 then 2 and 3x3x3 kernels."""
    if (len_keep is None or norm_batch_pooled
            or os.environ.get("ATK_BLOCK_SPARSE", "0") != "1"):
        return 0
    want = int(os.environ.get("ATK_BLOCK_SPARSE_STAGES", "2"))
    in_shape, grid = tuple(int(v) for v in in_shape), tuple(int(v) for v in grid)
    if any(s % g for s, g in zip(in_shape, grid)):
        return 0
    sizes = {s // g for s, g in zip(in_shape, grid)}
    if len(sizes) != 1:
        return 0
    bs = sizes.pop()
    n = 0
    for d in range(min(want, len(strides))):
        if tuple(kernels[d]) != (3, 3, 3):
            break
        if d == 0:
            if tuple(strides[d]) != (1, 1, 1):
                break
        else:
            if tuple(strides[d]) != (2, 2, 2) or bs % 2:
                break
            bs //= 2
        if bs < 4:
            break
        n = d + 1
    return n


class SparseSTUNetEncoder(nn.Module):
    """Masked STUNet encoder; forward(x, active) -> features, finest first.
    Stage 0 has stride 1, every later stage stride 2; depth[d] blocks in
    stage d (default one). With `remat` each stage runs under activation
    checkpointing; with `norm_batch_pooled` every norm pools its statistics
    over the batch (the reference's B > 1 law). `len_keep`, the mask's
    visible patches a sample, enables the block-sparse route of the first
    stages where `block_stage_count` allows it."""

    def __init__(self, in_channels: int = 1, dims: Sequence[int] = (32, 64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 depth: Optional[Sequence[int]] = None, remat: bool = False,
                 norm_batch_pooled: bool = False, len_keep: Optional[int] = None):
        super().__init__()
        self.dims = list(dims)
        self.depth = list(depth) if depth is not None else [1] * len(self.dims)
        self.remat, self.norm_batch_pooled, self.len_keep = remat, norm_batch_pooled, len_keep
        self.strides = [1] + [2] * (len(dims) - 1)
        cins = [in_channels] + self.dims[:-1]
        self.conv_blocks_context = nn.ModuleList(
            _SparseResStage(ci, co, n, s, dtype, generator, norm_batch_pooled)
            for ci, co, n, s in zip(cins, self.dims, self.depth, self.strides))

    def get_downsample_ratio(self) -> int:
        return 2 ** (len(self.dims) - 1)

    def _block_stage_count(self, x: torch.Tensor, active: torch.Tensor) -> int:
        return block_stage_count(x.shape[2:5], active.shape[2:5],
                                 [(s,) * 3 for s in self.strides], [(3, 3, 3)] * len(self.dims),
                                 self.len_keep, self.norm_batch_pooled)

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        n_bs = self._block_stage_count(x, active)
        if n_bs:
            grid = tuple(int(v) for v in active.shape[2:5])
            bs = int(x.shape[2]) // grid[0]
            idx = active_block_indices(active, self.len_keep)
            nb = neighbor_positions(idx, grid)
            xb = block_gather(x.permute(0, 2, 3, 4, 1), idx, grid, bs)
            for d in range(n_bs):
                xb = run_remat(self.remat, self.conv_blocks_context[d], xb, active, nb)
                bs //= self.strides[d]
                x = block_scatter(xb, idx, grid, bs).permute(0, 4, 1, 2, 3)
                feats.append(x)
        for stage in self.conv_blocks_context[n_bs:]:
            x = run_remat(self.remat, stage, x, active)
            feats.append(x)
        return feats

"""Masked ("sparse") 3D layers for SparK-style pretraining, dense-masked path.
Counterpart of anatomask_tpu/ssl/sparse.py.

The mask is passed explicitly to every layer as (B, 1, f1, f2, f3) bool,
True = visible, and dilated to any resolution by integer repeats (the
reference's repeat_interleave). Norms compute their statistics over the
visible voxels only and zero the rest. Module and parameter names follow the
reference torch STUNet head (`conv_blocks_context.{stage}.{block}.conv1...`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from anatomask_torch.models.layers import CL3D, ConvND, leaky_relu
from anatomask_torch.ops.moments import row_moments


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
    (B, C, 1, 1, 1); pooled over the batch as (1, C, 1, 1, 1). The sums come
    from the moments kernel, x*x squared in x's dtype as JAX's
    `_masked_moments` squares it; counts are clamped >= 1."""
    x = x.contiguous(memory_format=CL3D)
    s, ss = row_moments(x.permute(0, 2, 3, 4, 1), m[:, 0], square_in_dtype=True)
    cnt = m.sum((1, 2, 3, 4), dtype=torch.float32)[:, None]
    if batch_pooled:
        s, ss, cnt = s.sum(0, keepdim=True), ss.sum(0, keepdim=True), cnt.sum(0, keepdim=True)
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


class SparseBasicResBlock(nn.Module):
    """Masked residual block: conv1 (stride s) -> IN -> LeakyReLU -> conv2 ->
    IN, plus a 1x1 conv3 (stride s) on the skip, summed and LeakyReLU'd.

    Masking invariant: the block input is zero outside the visible voxels and
    so is its output. The masked norms weight their statistics by the mask and
    zero their output, so only the 1x1 skip needs an explicit re-mask."""

    def __init__(self, cin: int, cout: int, stride: int = 1, use_1x1conv: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dd = dict(dtype=dtype, generator=generator)
        self.dtype = dtype
        self.conv1 = ConvND(cin, cout, 3, stride, **dd)
        self.norm1 = SparseInstanceNorm(cout, dtype=dtype)
        self.conv2 = ConvND(cout, cout, 3, 1, **dd)
        self.norm2 = SparseInstanceNorm(cout, dtype=dtype)
        self.conv3 = ConvND(cin, cout, 1, stride, **dd) if use_1x1conv else None

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        y = leaky_relu(self.norm1(self.conv1(x), active))
        y = self.norm2(self.conv2(y), active)
        if self.conv3 is not None:
            x = self.conv3(x)
            x = x * mask_to_resolution(active, x.shape[2:5]).to(self.dtype)
        return leaky_relu(y + x)


class _SparseResStage(nn.ModuleList):
    """One stage of STUNet-B: a single block that strides and projects the
    skip. A list, so that parameter names keep the reference's block index."""

    def __init__(self, cin: int, cout: int, stride: int, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__([SparseBasicResBlock(cin, cout, stride, use_1x1conv=True,
                                              dtype=dtype, generator=generator)])

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        return self[0](x, active)


class SparseSTUNetEncoder(nn.Module):
    """Masked STUNet encoder, one block a stage; forward(x, active) ->
    features, finest first. Stage 0 has stride 1, every later stage stride 2."""

    def __init__(self, in_channels: int = 1, dims: Sequence[int] = (32, 64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims = list(dims)
        self.strides = [1] + [2] * (len(dims) - 1)
        cins = [in_channels] + self.dims[:-1]
        self.conv_blocks_context = nn.ModuleList(
            _SparseResStage(ci, co, s, dtype, generator)
            for ci, co, s in zip(cins, self.dims, self.strides))

    def get_downsample_ratio(self) -> int:
        return 2 ** (len(self.dims) - 1)

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for stage in self.conv_blocks_context:
            x = stage(x, active)
            feats.append(x)
        return feats

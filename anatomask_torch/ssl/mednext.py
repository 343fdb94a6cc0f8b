"""MedNeXt encoder (ConvNeXt-style) for SparK pretraining, masked.
Counterpart of anatomask_tpu/ssl/mednext.py.

A 1x1 stem, four stages of MedNeXt blocks (depthwise k7 conv -> per-channel
SparseGroupNorm -> 1x1 expansion by exp_r -> GELU -> 1x1 contraction ->
residual), each followed by a stride-2 block with a 1x1 strided residual,
then a bottleneck stage; widths n, 2n, 4n, 8n, 16n; features full resolution
to /16. Every conv output is re-masked at its resolution. With `remat` each
block runs under activation checkpointing (the JAX package's
`nn.remat(SparseMedNeXtBlock)`). No conv here is a 3x3x3 one, so none runs a
ported kernel: the depthwise and 1x1 convs are `F.conv3d`, as JAX leaves
them to XLA.

Names follow the reference MedNeXt head: `stem`, `enc_block_{s}.{b}`,
`down_{s}`, `bottleneck.{b}`, each block with `conv1` (depthwise), `norm`,
`conv2`, `conv3` and, where the shape changes, `res_conv`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as fn

from anatomask_torch.models.layers import ConvND, run_remat
from anatomask_torch.ssl.sparse import SparseGroupNorm, mask_to_resolution


class SparseMedNeXtBlock(nn.Module):
    def __init__(self, cin: int, cout: int, exp_r: int = 4, kernel_size: int = 7,
                 do_res: bool = True, stride: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dd = dict(dtype=dtype, generator=generator)
        self.do_res = do_res
        self.conv1 = ConvND(cin, cin, kernel_size, stride, groups=cin, **dd)
        self.norm = SparseGroupNorm(cin, cin, dtype=dtype)
        self.conv2 = ConvND(cin, exp_r * cin, 1, **dd)
        self.conv3 = ConvND(exp_r * cin, cout, 1, **dd)
        self.res_conv = (ConvND(cin, cout, 1, stride, **dd)
                         if do_res and (stride != 1 or cin != cout) else None)

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
        y = self.conv1(x)
        m = mask_to_resolution(active, y.shape[2:5]).to(y.dtype)
        y = self.norm(y * m, active)
        y = fn.gelu(self.conv2(y) * m, approximate="tanh")
        y = self.conv3(y) * m
        if not self.do_res:
            return y
        return y + (x if self.res_conv is None else self.res_conv(x) * m)


class SparseMedNeXtEncoder(nn.Module):
    """forward(x, active) -> 5 features, full resolution to /16, finest first."""

    def __init__(self, in_channels: int = 1, n_channels: int = 32, exp_r: int = 4,
                 kernel_size: int = 7, block_counts: Sequence[int] = (2, 2, 2, 2, 2),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        n = n_channels
        self.dims = [n, 2 * n, 4 * n, 8 * n, 16 * n]
        dd = dict(exp_r=exp_r, kernel_size=kernel_size, dtype=dtype, generator=generator)
        self.stem = ConvND(in_channels, n, 1, dtype=dtype, generator=generator)
        for s in range(4):
            setattr(self, f"enc_block_{s}", nn.ModuleList(
                SparseMedNeXtBlock(self.dims[s], self.dims[s], **dd)
                for _ in range(block_counts[s])))
            setattr(self, f"down_{s}",
                    SparseMedNeXtBlock(self.dims[s], self.dims[s + 1], stride=2, **dd))
        self.bottleneck = nn.ModuleList(SparseMedNeXtBlock(self.dims[4], self.dims[4], **dd)
                                        for _ in range(block_counts[4]))

    def get_downsample_ratio(self) -> int:
        return 16

    def forward(self, x: torch.Tensor, active: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x)
        x = x * mask_to_resolution(active, x.shape[2:5]).to(x.dtype)
        feats = []
        for s in range(4):
            for block in getattr(self, f"enc_block_{s}"):
                x = run_remat(self.remat, block, x, active)
            feats.append(x)
            x = run_remat(self.remat, getattr(self, f"down_{s}"), x, active)
        for block in self.bottleneck:
            x = run_remat(self.remat, block, x, active)
        feats.append(x)
        return feats

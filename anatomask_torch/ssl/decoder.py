"""LightDecoder for masked-image-modeling pretraining. Counterpart of the main
path of anatomask_tpu/ssl/decoder.py (ConvTranspose2x, UNetBlock,
LightDecoder with norm "in"). Names follow the reference torch decoder:
`dec.{i}.up_sample`, `dec.{i}.conv.{0,1,3,4}` and `proj`.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as fn

from anatomask_torch.models.layers import ConvND, InstanceNorm, trunc_normal_


class ConvTranspose2x(nn.Module):
    """torch ConvTranspose3d(k=4, s=2, p=1) with bias: out = 2 * in. Weight
    (I, O, 4, 4, 4) as torch keeps it; the bias is added in the compute dtype."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, 4, 4, 4))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            trunc_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fn.conv_transpose3d(x.to(self.dtype), self.weight.to(self.dtype), None, 2, 1)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)


class UNetBlock(nn.Sequential):
    """up_sample, then conv0 -> IN -> ReLU6 -> conv1 -> IN, bias-free convs."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dd = dict(bias=False, dtype=dtype, init="trunc", generator=generator)
        self.up_sample = ConvTranspose2x(cin, cin, dtype, generator)
        self.conv = nn.Sequential(
            ConvND(cin, cin, 3, **dd), InstanceNorm(cin, dtype=dtype), nn.ReLU6(),
            ConvND(cin, cout, 3, **dd), InstanceNorm(cout, dtype=dtype))


class LightDecoder(nn.Module):
    """log2(up_sample_ratio) UNetBlocks halving the width, additive skips
    x = x + to_dec[i] before each block, and a 1x1 projection. Norm "in"."""

    def __init__(self, up_sample_ratio: int, width: int = 768, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if up_sample_ratio & (up_sample_ratio - 1):
            raise ValueError(f"up_sample_ratio must be a power of 2, got {up_sample_ratio}")
        self.width = width
        n = round(math.log2(up_sample_ratio))
        channels = [width // 2 ** i for i in range(n + 1)]
        self.dec = nn.ModuleList(
            UNetBlock(channels[i], channels[i + 1], dtype, generator) for i in range(n))
        self.proj = ConvND(channels[-1], out_channels, 1, bias=True, dtype=dtype,
                           init="trunc", generator=generator)

    def forward(self, to_dec: List[torch.Tensor]) -> torch.Tensor:
        """to_dec: one skip per block, coarsest first."""
        x = 0
        for block, skip in zip(self.dec, to_dec, strict=True):
            x = block(x + skip)
        return self.proj(x)

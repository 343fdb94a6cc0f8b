"""Dense reconstruction decoders for masked-image-modeling pretraining.
Counterpart of anatomask_tpu/ssl/decoder.py: ConvTranspose2x, UNetBlock,
LightDecoder with norm "in" or "bn" and per-block activation checkpointing
(`remat`), and the ablation decoders DSDecoder, SMiMDecoder and
SMiMTwoDecoder. Names follow the reference torch decoder: `dec.{i}.up_sample`,
`dec.{i}.conv.{0,1,3,4}` and `proj`; the ablation decoders' own layers are
`ds_projs.{i}`, `up` and `ups.{i}`.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as fn

from anatomask_torch.models.layers import BatchNorm, ConvND, InstanceNorm, run_remat, trunc_normal_


class ConvTranspose(nn.Module):
    """torch ConvTranspose3d(k, stride s, padding p) with bias. Weight (I, O,
    k, k, k) as torch keeps it; computed in the compute dtype, the bias added
    in it. The JAX package's transposed convs with padding q on each side of
    the dilated input are this layer with p = k - 1 - q."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int, padding: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, *(kernel_size,) * 3))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            trunc_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = fn.conv_transpose3d(x.to(self.dtype), self.weight.to(self.dtype), None,
                                self.stride, self.padding)
        return y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)


class ConvTranspose2x(ConvTranspose):
    """torch ConvTranspose3d(k=4, s=2, p=1): out = 2 * in."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cin, cout, 4, 2, 1, dtype, generator)


def make_norm(kind: str, channels: int, dtype: torch.dtype) -> nn.Module:
    """The decoder norm: "in" InstanceNorm, anything else the training-mode
    BatchNorm (statistics over the batch and the voxels), as `_make_norm`."""
    return (InstanceNorm if kind == "in" else BatchNorm)(channels, dtype=dtype)


class UNetBlock(nn.Sequential):
    """up_sample, then conv0 -> norm -> ReLU6 -> conv1 -> norm, bias-free convs."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, norm: str = "in"):
        super().__init__()
        dd = dict(bias=False, dtype=dtype, init="trunc", generator=generator)
        self.up_sample = ConvTranspose2x(cin, cin, dtype, generator)
        self.conv = nn.Sequential(
            ConvND(cin, cin, 3, **dd), make_norm(norm, cin, dtype), nn.ReLU6(),
            ConvND(cin, cout, 3, **dd), make_norm(norm, cout, dtype))


def _widths(up_sample_ratio: int, width: int) -> List[int]:
    if up_sample_ratio & (up_sample_ratio - 1):
        raise ValueError(f"up_sample_ratio must be a power of 2, got {up_sample_ratio}")
    return [width // 2 ** i for i in range(round(math.log2(up_sample_ratio)) + 1)]


class LightDecoder(nn.Module):
    """log2(up_sample_ratio) UNetBlocks halving the width, additive skips
    x = x + to_dec[i] before each block, and a 1x1 projection. With `remat`
    each block runs under activation checkpointing."""

    def __init__(self, up_sample_ratio: int, width: int = 768, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, norm: str = "in",
                 remat: bool = False):
        super().__init__()
        self.width, self.remat = width, remat
        channels = _widths(up_sample_ratio, width)
        self.dec = nn.ModuleList(
            UNetBlock(channels[i], channels[i + 1], dtype, generator, norm)
            for i in range(len(channels) - 1))
        self.proj = ConvND(channels[-1], out_channels, 1, bias=True, dtype=dtype,
                           init="trunc", generator=generator)

    def forward(self, to_dec: List[torch.Tensor]) -> torch.Tensor:
        """to_dec: one skip per block, coarsest first."""
        x = 0
        for block, skip in zip(self.dec, to_dec, strict=True):
            x = run_remat(self.remat, block, x + skip)
        return self.proj(x)


class DSDecoder(nn.Module):
    """LightDecoder's blocks with a 1x1 reconstruction head after each
    (`ds_projs.{i}`), for deep supervision; returns every head's output,
    coarsest first."""

    def __init__(self, up_sample_ratio: int, width: int = 768, out_channels: int = 1,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, norm: str = "in"):
        super().__init__()
        channels = _widths(up_sample_ratio, width)
        self.width = width
        self.dec = nn.ModuleList(
            UNetBlock(channels[i], channels[i + 1], dtype, generator, norm)
            for i in range(len(channels) - 1))
        self.ds_projs = nn.ModuleList(
            ConvND(c, out_channels, 1, bias=True, dtype=dtype, init="trunc", generator=generator)
            for c in channels[1:])

    def forward(self, to_dec: List[torch.Tensor]) -> List[torch.Tensor]:
        x, outs = 0, []
        for block, head, skip in zip(self.dec, self.ds_projs, to_dec, strict=True):
            x = block(x + skip)
            outs.append(head(x))
        return outs


def _smim_up(cin: int, cout: int, r: int, dtype, generator) -> ConvTranspose:
    """The JAX package's ConvTranspose(kernel 2r, stride r, padding r // 2 on
    each side of the dilated input)."""
    return ConvTranspose(cin, cout, 2 * r, r, 2 * r - 1 - r // 2, dtype, generator)


class SMiMDecoder(nn.Module):
    """SimMIM-style decoder: one transposed conv (kernel 2r, stride r) from the
    coarsest feature, GELU (tanh form), a 1x1 projection; r the ratio."""

    def __init__(self, in_channels: int, up_sample_ratio: int, width: int = 768,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        self.up = _smim_up(in_channels, width // 2, up_sample_ratio, dtype, generator)
        self.proj = ConvND(width // 2, out_channels, 1, bias=True, dtype=dtype, init="trunc",
                           generator=generator)

    def forward(self, to_dec: List[torch.Tensor]) -> torch.Tensor:
        return self.proj(fn.gelu(self.up(to_dec[0]), approximate="tanh"))


class SMiMTwoDecoder(nn.Module):
    """SMiMDecoder in two transposed convs of stride sqrt(ratio), widths
    max(width / 2, 16) and max(width / 4, 16), each followed by GELU."""

    def __init__(self, in_channels: int, up_sample_ratio: int, width: int = 768,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.width = width
        r = int(round(up_sample_ratio ** 0.5))
        widths = [in_channels] + [max(width // 2 ** (i + 1), 16) for i in range(2)]
        self.ups = nn.ModuleList(_smim_up(widths[i], widths[i + 1], r, dtype, generator)
                                 for i in range(2))
        self.proj = ConvND(widths[-1], out_channels, 1, bias=True, dtype=dtype, init="trunc",
                           generator=generator)

    def forward(self, to_dec: List[torch.Tensor]) -> torch.Tensor:
        x = to_dec[0]
        for up in self.ups:
            x = fn.gelu(up(x), approximate="tanh")
        return self.proj(x)

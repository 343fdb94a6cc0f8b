"""Shared layers: 3D conv with torch k//2 padding, InstanceNorm with fp32
statistics from the moments kernel, LeakyReLU, nearest upsampling.
Counterpart of anatomask_tpu/models/layers.py.

Activations are NCDHW in `torch.channels_last_3d` memory (NDHWC underneath),
so the 3x3x3 kernel gets a contiguous NDHWC view by a free permute.

Rounding follows the JAX model at bf16: conv inputs and weights are cast to
the compute dtype, conv outputs come back rounded to it, and the bias is added
in it. Norm statistics are fp32, with x widened to fp32 before it is squared
(the JAX model squares in the compute dtype, so at bf16 the two differ by that
rounding); the affine is applied in the compute dtype. No autocast.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as fn

from anatomask_torch.ops.conv3x3 import conv3d_3x3
from anatomask_torch.ops.moments import row_moments

CL3D = torch.channels_last_3d


def _triple(v: Union[int, Sequence[int]]) -> Tuple[int, int, int]:
    return (int(v),) * 3 if isinstance(v, int) else tuple(int(k) for k in v)


def he_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None,
               negative_slope: float = 1e-2) -> torch.Tensor:
    """nnU-Net's InitWeights_He(1e-2): normal, variance 2/(1+a^2)/fan_in."""
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(2.0 / (1.0 + negative_slope ** 2) / fan_in)
    return nn.init.normal_(w, 0.0, std, generator=generator)


def trunc_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None,
                  std: float = 0.02) -> torch.Tensor:
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class ConvND(nn.Module):
    """3D conv, kernel k, stride s (an int or one per axis), torch padding
    k//2. The stride-1 3x3x3 conv goes to the hand-written kernel
    (`conv3d_3x3`); every other conv (stride 2, 1x1x1, anisotropic kernels)
    stays `F.conv3d`, as plain convs the JAX package leaves to XLA.
    Parameters `weight` (O, I, *k) and `bias` as in torch's Conv3d."""

    def __init__(self, cin: int, cout: int, kernel_size: Union[int, Sequence[int]],
                 stride: Union[int, Sequence[int]] = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "he",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size, self.stride = _triple(kernel_size), _triple(stride)
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        with torch.no_grad():
            (he_normal_ if init == "he" else trunc_normal_)(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).contiguous(memory_format=CL3D)
        w = self.weight.to(self.dtype)
        if self.kernel_size == (3, 3, 3) and self.stride == (1, 1, 1):
            y = conv3d_3x3(x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0))
            y = y.permute(0, 4, 1, 2, 3)
        else:
            y = fn.conv3d(x, w, None, self.stride, tuple(k // 2 for k in self.kernel_size))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)
        return y


class InstanceNorm(nn.Module):
    """torch InstanceNorm3d(affine=True) semantics, eps 1e-5, fp32
    statistics from the moments kernel (`row_moments`), affine a*x+b applied
    in the compute dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=CL3D)
        s, ss = row_moments(x.permute(0, 2, 3, 4, 1))
        cnt = float(math.prod(x.shape[2:]))
        mean = s / cnt
        var = (ss / cnt - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + self.eps) * self.weight.float()
        b = self.bias.float() - mean * a
        dt = self.dtype
        return x.to(dt) * a.to(dt)[:, :, None, None, None] + b.to(dt)[:, :, None, None, None]


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return fn.leaky_relu(x, negative_slope)


def upsample_nearest(x: torch.Tensor, scale: Sequence[int]) -> torch.Tensor:
    """Integer-factor nearest upsampling of an NCDHW tensor (torch
    interpolate(mode='nearest') == a repeat per spatial axis), written in one
    copy and returned in channels_last_3d memory."""
    B, C, X, Y, Z = x.shape
    sx, sy, sz = _triple(scale)
    y = x.permute(0, 2, 3, 4, 1)[:, :, None, :, None, :, None, :]
    y = y.expand(B, X, sx, Y, sy, Z, sz, C).reshape(B, X * sx, Y * sy, Z * sz, C)
    return y.permute(0, 4, 1, 2, 3)

"""STUNet family (S/B/L/H): the residual encoder/decoder segmentation network.
Counterpart of anatomask_tpu/models/stunet.py (BasicResBlock, _ResStage,
UpsampleLayerNearest, STUNet, stunet_preset).

Layout NCDHW in channels_last_3d memory. Module and parameter names are the
reference torch STUNet's (`conv_blocks_context.{d}.{b}.conv1`,
`upsample_layers.{u}.conv`, `conv_blocks_localization.{u}.{b}`,
`seg_outputs.{u}`), so `convert.stunet_state_dict_from_jax` carries the JAX
package's parameters across and its `convert_torch_stunet_state_dict` carries
them back.

- encoder: num_pool + 1 stages; stage d = BasicResBlock(stride = pool[d - 1],
  1x1 skip) + (depth[d] - 1) unit-stride blocks;
- decoder: nearest upsample + 1x1 conv, concat with the skip, a stage of
  BasicResBlocks, a 1x1 seg head per stage; with deep supervision the heads
  come back highest resolution first;
- with `remat` every stage (`_ResStage`, encoder and decoder) runs under
  activation checkpointing, as the JAX package's `nn.remat(_ResStage)`;
  STUNet-H (`stunet_preset("huge")`) has it by default.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from anatomask_torch.device import resolve_device
from anatomask_torch.models.layers import (ConvND, InstanceNorm, fused, leaky_relu, run_remat,
                                           upsample_nearest)


class BasicResBlock(nn.Module):
    """conv1 (stride s) -> IN -> LeakyReLU -> conv2 -> IN, plus the skip (a
    1x1 conv3 with stride s where the shape changes), summed and LeakyReLU'd."""

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int],
                 stride: Sequence[int] = (1, 1, 1), use_1x1conv: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dd = dict(dtype=dtype, generator=generator)
        self.conv1 = ConvND(cin, cout, kernel_size, stride, **dd)
        self.norm1 = InstanceNorm(cout, dtype=dtype)
        self.conv2 = ConvND(cout, cout, kernel_size, 1, **dd)
        self.norm2 = InstanceNorm(cout, dtype=dtype)
        self.conv3 = ConvND(cin, cout, 1, stride, **dd) if use_1x1conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if fused(self, x, self.norm2.dtype) and (self.conv3 is not None
                                                  or x.dtype == self.norm2.dtype):
            # two passes of ops/norm_act.py in place of ten (layers.py)
            y = self.norm1.epilogue(self.conv1.without_bias(x), self.conv1.bias, act=True)
            y = self.conv2.without_bias(y)
            skip, skip_bias = ((x, None) if self.conv3 is None
                               else (self.conv3.without_bias(x), self.conv3.bias))
            return self.norm2.epilogue(y, self.conv2.bias, True, skip, skip_bias)
        y = leaky_relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.conv3 is not None:
            x = self.conv3(x)
        return leaky_relu(y + x)


class _ResStage(nn.Sequential):
    """depth x BasicResBlock; the first block carries the stride and the 1x1
    skip."""

    def __init__(self, cin: int, cout: int, depth: int, kernel_size: Sequence[int],
                 stride: Sequence[int], dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        blocks = [BasicResBlock(cin, cout, kernel_size, stride, use_1x1conv=True,
                                dtype=dtype, generator=generator)]
        blocks += [BasicResBlock(cout, cout, kernel_size, dtype=dtype, generator=generator)
                   for _ in range(1, depth)]
        super().__init__(*blocks)


class UpsampleLayerNearest(nn.Module):
    """Nearest upsampling by `scale`, then a 1x1 conv to `cout` channels."""

    def __init__(self, cin: int, cout: int, scale: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = tuple(scale)
        self.conv = ConvND(cin, cout, 1, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest(x, self.scale))


class STUNet(nn.Module):
    """Full segmentation STUNet. forward(x (B, C_in, X, Y, Z)) -> the
    full-resolution logits, or with deep supervision a tuple of every head's
    logits, highest resolution first."""

    def __init__(self, input_channels: int, num_classes: int,
                 depth: Sequence[int] = (1, 1, 1, 1, 1, 1),
                 dims: Sequence[int] = (32, 64, 128, 256, 512, 512),
                 pool_op_kernel_sizes: Optional[Sequence[Sequence[int]]] = None,
                 conv_kernel_sizes: Optional[Sequence[Sequence[int]]] = None,
                 deep_supervision: bool = True, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        num_pool = len(dims) - 1
        pools = ([tuple(p) for p in pool_op_kernel_sizes] if pool_op_kernel_sizes is not None
                 else [(2, 2, 2)] * num_pool)
        kernels = ([tuple(k) for k in conv_kernel_sizes] if conv_kernel_sizes is not None
                   else [(3, 3, 3)] * len(dims))
        if len(pools) != num_pool or len(kernels) != len(dims):
            raise ValueError(f"need {num_pool} pool and {len(dims)} conv kernel sizes, got "
                             f"{len(pools)} and {len(kernels)}")
        self.deep_supervision = deep_supervision
        dd = dict(dtype=dtype, generator=generator)
        cins = [input_channels] + list(dims[:-1])
        strides = [(1, 1, 1)] + pools
        self.conv_blocks_context = nn.ModuleList(
            _ResStage(cins[d], dims[d], depth[d], kernels[d], strides[d], **dd)
            for d in range(num_pool + 1))
        self.upsample_layers = nn.ModuleList(
            UpsampleLayerNearest(dims[-1 - u], dims[-2 - u], pools[-1 - u], **dd)
            for u in range(num_pool))
        self.conv_blocks_localization = nn.ModuleList(
            _ResStage(2 * dims[-2 - u], dims[-2 - u], depth[-2 - u], kernels[-2 - u],
                      (1, 1, 1), **dd)
            for u in range(num_pool))
        self.seg_outputs = nn.ModuleList(
            ConvND(dims[-2 - u], num_classes, 1, **dd) for u in range(num_pool))

    def forward(self, x: torch.Tensor):
        skips = []
        for stage in self.conv_blocks_context:
            x = run_remat(self.remat, stage, x)
            skips.append(x)
        x = skips.pop()
        seg_outputs = []
        for up, stage, head in zip(self.upsample_layers, self.conv_blocks_localization,
                                   self.seg_outputs):
            # concat along C in NDHWC, so that the result is contiguous
            # channels_last_3d memory for the kernels that read it
            x = torch.cat([up(x).permute(0, 2, 3, 4, 1),
                           skips.pop().permute(0, 2, 3, 4, 1)], dim=-1)
            x = run_remat(self.remat, stage, x.permute(0, 4, 1, 2, 3))
            if self.deep_supervision:
                seg_outputs.append(head(x))
        if self.deep_supervision:
            return tuple(seg_outputs[::-1])
        return self.seg_outputs[-1](x)  # the lower heads' outputs would go unread


_PRESETS = {
    # name: (width multiplier, depth per stage)
    "small": (16, (1, 1, 1, 1, 1, 1)),
    "base": (32, (1, 1, 1, 1, 1, 1)),
    "large": (64, (2, 2, 2, 2, 2, 2)),
    "huge": (96, (3, 3, 3, 3, 3, 3)),
}


def stunet_preset(name: str, input_channels: int, num_classes: int,
                  pool_op_kernel_sizes=None, conv_kernel_sizes=None,
                  deep_supervision: bool = True, dtype: torch.dtype = torch.float32,
                  device="cuda", generator: Optional[torch.Generator] = None,
                  remat: Optional[bool] = None) -> STUNet:
    """STUNet-S/B/L/H (dims = mult * [1, 2, 4, 8, 16, 16]), initialised on the
    CPU from `generator` (default: seed 0), then moved to `device`. remat
    None: on for "huge" only, as the JAX preset."""
    if name not in _PRESETS:
        raise ValueError(f"unknown STUNet preset {name!r}; choose from {sorted(_PRESETS)}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    mult, depth = _PRESETS[name]
    net = STUNet(input_channels, num_classes, depth, [mult * x for x in (1, 2, 4, 8, 16, 16)],
                 pool_op_kernel_sizes, conv_kernel_sizes, deep_supervision, dtype, generator,
                 remat=name == "huge" if remat is None else remat)
    return net.to(device)

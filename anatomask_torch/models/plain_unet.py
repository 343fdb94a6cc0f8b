"""nnU-Net's plans-driven U-Nets: PlainConvUNet (nnU-Net's default
architecture) and ResidualEncoderUNet. Counterpart of
anatomask_tpu/models/plain_unet.py (ConvNormAct, _ConvStage, PlainConvUNet,
ResidualEncoderUNet).

Layout NCDHW in channels_last_3d memory. Module and parameter names are the
torch ones that the JAX package's adapters read
(`training/checkpoint.py` `convert_torch_plain_unet_state_dict`,
`convert_torch_resenc_state_dict`): `encoder.stages.{s}.convs.{i}.conv` and
`.norm` (PlainConvUNet), `encoder.stages.{s}.blocks.{b}.conv1` ... (the
residual encoder, the port's STUNet `BasicResBlock`),
`decoder.transpconvs.{d}`, `decoder.stages.{d}.convs.{i}`,
`decoder.seg_layers.{d}`; `convert.plain_unet_state_dict_from_jax` and
`convert.resenc_state_dict_from_jax` carry the JAX parameters across.

- encoder stage s: n_conv_per_stage[s] x (conv - norm - LeakyReLU), the
  first conv strided by strides[s]; the residual encoder has
  n_blocks_per_stage[s] residual blocks instead, the first strided, with a
  1x1 skip where the shape changes;
- decoder stage d: a kernel = stride transposed conv up to skip level
  n_stages - 2 - d, concat with that skip, n_conv_per_stage_decoder[d]
  convs, a 1x1 seg head. With deep supervision every head comes back,
  highest resolution first; without, only the last head is computed (the
  JAX model's other heads go unread);
- with `remat`, activation checkpointing as the JAX models place it: every
  PlainConvUNet stage, every residual block of the residual encoder, every
  decoder stage.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from anatomask_torch.models.layers import (BatchNorm, ConvND, InstanceNorm,
                                           SubpixelConvTranspose, fused, leaky_relu, run_remat)
from anatomask_torch.models.stunet import BasicResBlock


class ConvNormAct(nn.Module):
    """conv (stride on request) -> InstanceNorm or BatchNorm -> LeakyReLU."""

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int], stride: Sequence[int],
                 norm: str, dtype: torch.dtype, generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = ConvND(cin, cout, kernel_size, stride, dtype=dtype, generator=generator)
        self.norm = (BatchNorm if norm == "batch" else InstanceNorm)(cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if fused(self, x, self.norm.dtype):  # one pass of ops/norm_act.py (layers.py)
            return self.norm.epilogue(self.conv.without_bias(x), self.conv.bias, act=True)
        return leaky_relu(self.norm(self.conv(x)))


class StackedConvs(nn.Module):
    """n ConvNormAct; the first carries the stride."""

    def __init__(self, cin: int, cout: int, n: int, kernel_size: Sequence[int],
                 stride: Sequence[int], norm: str, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.convs = nn.Sequential(*(
            ConvNormAct(cin if i == 0 else cout, cout, kernel_size, stride if i == 0 else 1,
                        norm, dtype, generator) for i in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)


class ResidualBlocks(nn.Module):
    """n BasicResBlock; the first carries the stride and, where the shape
    changes, the 1x1 skip. With `remat` each block is checkpointed."""

    def __init__(self, cin: int, cout: int, n: int, kernel_size: Sequence[int],
                 stride: Sequence[int], dtype: torch.dtype,
                 generator: Optional[torch.Generator], remat: bool = False):
        super().__init__()
        self.remat = remat
        proj = any(s != 1 for s in stride) or cin != cout
        self.blocks = nn.Sequential(*(
            BasicResBlock(cin, cout, kernel_size, stride, use_1x1conv=proj, dtype=dtype,
                          generator=generator) if b == 0 else
            BasicResBlock(cout, cout, kernel_size, dtype=dtype, generator=generator)
            for b in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = run_remat(self.remat, block, x)
        return x


class Encoder(nn.Module):
    """The stages in turn, each checkpointed where `remat`."""

    def __init__(self, stages: List[nn.Module], remat: bool = False):
        super().__init__()
        self.stages = nn.ModuleList(stages)
        self.remat = remat

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for stage in self.stages:
            x = run_remat(self.remat, stage, x)
            skips.append(x)
        return skips


class Decoder(nn.Module):
    """Transposed conv up, concat the skip, a conv stack, a 1x1 seg head."""

    def __init__(self, num_classes: int, features: Sequence[int],
                 kernel_sizes: Sequence[Sequence[int]], strides: Sequence[Sequence[int]],
                 n_conv_per_stage: Sequence[int], norm: str, deep_supervision: bool,
                 dtype: torch.dtype, generator: Optional[torch.Generator], remat: bool = False):
        super().__init__()
        self.deep_supervision, self.remat = deep_supervision, remat
        n = len(features)
        dd = dict(dtype=dtype, generator=generator)
        tgts = [n - 2 - d for d in range(n - 1)]  # the skip level decoder stage d ends at
        self.transpconvs = nn.ModuleList(
            SubpixelConvTranspose(features[t + 1], features[t], strides[t + 1], **dd)
            for t in tgts)
        self.stages = nn.ModuleList(
            StackedConvs(2 * features[t], features[t], n_conv_per_stage[d], kernel_sizes[t], 1,
                         norm, **dd) for d, t in enumerate(tgts))
        self.seg_layers = nn.ModuleList(ConvND(features[t], num_classes, 1, **dd) for t in tgts)

    def forward(self, skips: List[torch.Tensor]):
        x = skips[-1]
        seg_outputs = []
        for d, (up, stage) in enumerate(zip(self.transpconvs, self.stages)):
            # concat along C in NDHWC, so that the result is contiguous
            # channels_last_3d memory for the kernels that read it
            x = torch.cat([up(x).permute(0, 2, 3, 4, 1),
                           skips[-2 - d].permute(0, 2, 3, 4, 1)], dim=-1)
            x = run_remat(self.remat, stage, x.permute(0, 4, 1, 2, 3))
            if self.deep_supervision:
                seg_outputs.append(self.seg_layers[d](x))
        if self.deep_supervision:
            return tuple(seg_outputs[::-1])
        return self.seg_layers[-1](x)  # the lower heads' outputs would go unread


class _UNet(nn.Module):
    """forward(x (B, C_in, X, Y, Z)) -> the full-resolution logits, or with
    deep supervision every head's, highest resolution first."""

    def __init__(self, encoder: Encoder, decoder: Decoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder

    def forward(self, x: torch.Tensor):
        return self.decoder(self.encoder(x))


class PlainConvUNet(_UNet):
    """nnU-Net's default network. strides[0] is the stem's (all 1 in
    nnU-Net's plans); norm is "instance" or "batch"."""

    def __init__(self, input_channels: int, num_classes: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes: Sequence[Sequence[int]],
                 strides: Sequence[Sequence[int]], n_conv_per_stage: Sequence[int],
                 n_conv_per_stage_decoder: Sequence[int], deep_supervision: bool = True,
                 norm: str = "instance", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        f = list(features_per_stage)[:n_stages]
        cins = [input_channels] + f[:-1]
        super().__init__(
            Encoder([StackedConvs(cins[s], f[s], n_conv_per_stage[s], kernel_sizes[s],
                                  strides[s], norm, dtype, generator) for s in range(n_stages)],
                    remat),
            Decoder(num_classes, f, kernel_sizes, strides, n_conv_per_stage_decoder, norm,
                    deep_supervision, dtype, generator, remat))


class ResidualEncoderUNet(_UNet):
    """PlainConvUNet with a residual encoder: stage s is n_blocks_per_stage[s]
    BasicResBlocks. The decoder is PlainConvUNet's, with instance norms."""

    def __init__(self, input_channels: int, num_classes: int, n_stages: int,
                 features_per_stage: Sequence[int], kernel_sizes: Sequence[Sequence[int]],
                 strides: Sequence[Sequence[int]], n_blocks_per_stage: Sequence[int],
                 n_conv_per_stage_decoder: Sequence[int], deep_supervision: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, remat: bool = False):
        f = list(features_per_stage)[:n_stages]
        cins = [input_channels] + f[:-1]
        super().__init__(
            Encoder([ResidualBlocks(cins[s], f[s], n_blocks_per_stage[s], kernel_sizes[s],
                                    strides[s], dtype, generator, remat)
                     for s in range(n_stages)]),
            Decoder(num_classes, f, kernel_sizes, strides, n_conv_per_stage_decoder, "instance",
                    deep_supervision, dtype, generator, remat))

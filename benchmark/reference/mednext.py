"""Plain PyTorch reference of the MedNeXt encoder head as AnatoMask pretrains
it: the masked MedNeXt encoder under SparK's densify layers and LightDecoder,
the per-patch normalised L2 loss, the teacher-guided hard mask, AdamW after
the global-norm clip and the EMA teacher.

Written from MedNeXt (Roy et al., arXiv:2303.09975) and AnatoMask's encoder
head (ricklisz/AnatoMask, `nnunetv2/training/nnUNetTrainer/variants/
pretrain/MedNeXt_head.py`): a 1x1 stem; four stages of MedNeXt blocks, each
stage closed by a stride-2 down block; a bottleneck stage; widths n, 2n,
4n, 8n, 16n (`stage_widths`), `blocks_per_stage` blocks a stage. A block is
a depthwise k^3 conv, a GroupNorm of one group a channel, a 1x1 conv to
`exp_r` times the channels, GELU, a 1x1 conv back, and the residual; a down
block's depthwise conv has stride 2 and its residual is a stride-2 1x1 conv.
NCDHW, float32, `F.conv3d` with TF32 off (`float32_exact`), no kernels, no
activation checkpointing. It imports nothing of the measured program.

The densify layers, the decoder, the loss, the masks, AdamW, the EMA and
`Quant` (every conv's arithmetic, the depthwise and 1x1 ones included, so
that the float8 control reaches them) are `reference/stunet.py`'s, and the
step is `reference/anatomask.py`'s. Parameters are keyed by the state-dict
names of the MedNeXt head inside SparK (`sparse_encoder.sp_cnn.stem`,
`enc_block_{s}.{b}`, `down_{s}`, `bottleneck.{b}`; `conv1` depthwise,
`norm`, `conv2`, `conv3`, `res_conv`).

Departures from MedNeXt_head.py:
- GELU in its tanh form, the measured program's (after flax's default);
  MedNeXt_head.py's `nn.GELU()` is the exact erf form.
- SparK's sparse law, as SparK's sparse encoder runs a dense model: every
  conv output is multiplied by the patch mask at its resolution, and the
  norm's mean and variance (two passes, eps 1e-5) are taken over the
  visible voxels only.
- The weights are drawn by the benchmark (`spark_params`: He normal over the
  fan-in for every conv, nnU-Net's `InitWeights_He`; norm weights ones,
  biases zeros; the decoder's as `reference/stunet.py` draws them).
- No gradient checkpointing; MedNeXt's optional GRN and deep supervision,
  which the head leaves off, are absent.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference import stunet
from benchmark.reference.stunet import (EXACT, Params, Quant, conv_transpose, float32_exact,
                                        instance_norm, patchify, upsample_mask)

__all__ = ["spark_params", "spark_forward", "float32_exact", "EXACT"]

PREFIX = "sparse_encoder.sp_cnn."


def conv(q: Quant, x, w, b=None, stride=1, groups=1):
    """A conv of k^3 taps at padding k // 2 (depthwise where `groups` is the
    channel count), its operands through `q`."""
    return q.out(F.conv3d(q.act(x), q.weight(w), b, stride, w.shape[2] // 2, groups=groups))


def gelu(x):
    return F.gelu(x, approximate="tanh")


# --- parameter tables --------------------------------------------------------

def _block_params(name: str, cin: int, cout: int, exp_r: int, k: int, stride: int) -> list:
    out = stunet._conv(f"{name}.conv1", 1, cin, k) + stunet._norm(f"{name}.norm", cin)
    out += stunet._conv(f"{name}.conv2", cin, exp_r * cin, 1)
    out += stunet._conv(f"{name}.conv3", exp_r * cin, cout, 1)
    if stride != 1 or cin != cout:
        out += stunet._conv(f"{name}.res_conv", cin, cout, 1)
    return out


def encoder_blocks(cfg: dict) -> List[tuple]:
    """(name, cin, cout, stride) of every block of the encoder, in order."""
    w, n = cfg["stage_widths"], cfg["blocks_per_stage"]
    out = []
    for s in range(4):
        out += [(f"enc_block_{s}.{b}", w[s], w[s], 1) for b in range(n[s])]
        out.append((f"down_{s}", w[s], w[s + 1], 2))
    return out + [(f"bottleneck.{b}", w[4], w[4], 1) for b in range(n[4])]


def spark_params(cfg: dict) -> list:
    """(name, shape, init law) of every parameter of the MedNeXt SparK: the
    encoder head, then the densify layers, mask tokens and LightDecoder of
    `reference/stunet.py`'s table (which depends on the widths alone)."""
    out = stunet._conv(f"{PREFIX}stem", cfg["in_channels"], cfg["stage_widths"][0], 1)
    for name, cin, cout, stride in encoder_blocks(cfg):
        out += _block_params(PREFIX + name, cin, cout, cfg["exp_r"], cfg["kernel_size"], stride)
    return out + [e for e in stunet.spark_params(cfg) if not e[0].startswith("sparse_encoder.")]


# --- the SparK model ---------------------------------------------------------

def _block(P: Params, name: str, x, stride: int, active, q: Quant):
    y = conv(q, x, P[f"{name}.conv1.weight"], P[f"{name}.conv1.bias"], stride, groups=x.shape[1])
    m = upsample_mask(active, y.shape[2:])
    y = instance_norm(y * m, P[f"{name}.norm.weight"], P[f"{name}.norm.bias"], 1e-5, m)
    y = gelu(conv(q, y, P[f"{name}.conv2.weight"], P[f"{name}.conv2.bias"]) * m)
    y = conv(q, y, P[f"{name}.conv3.weight"], P[f"{name}.conv3.bias"]) * m
    if f"{name}.res_conv.weight" in P:
        x = conv(q, x, P[f"{name}.res_conv.weight"], P[f"{name}.res_conv.bias"], stride) * m
    return y + x


def encode(P: Params, cfg: dict, x, active, q: Quant = EXACT) -> List[torch.Tensor]:
    """The features before each down block and the bottleneck's, finest
    first, under the patch mask `active` (B, 1, f1, f2, f3)."""
    x = conv(q, x, P[f"{PREFIX}stem.weight"], P[f"{PREFIX}stem.bias"])
    x = x * upsample_mask(active, x.shape[2:])
    feats = []
    for name, _, _, stride in encoder_blocks(cfg):
        if stride == 2:
            feats.append(x)
        x = _block(P, PREFIX + name, x, stride, active, q)
    return feats + [x]


def spark_forward(P: Params, cfg: dict, x: torch.Tensor, active: torch.Tensor,
                  q: Quant = EXACT):
    """SparK: the encoder on x with the masked patches zeroed, each feature
    but the finest densified (masked instance norm, eps 1e-6; mask tokens
    where masked; projection to the decoder's width), the LightDecoder with
    additive skips, the 1x1 projection (`reference/stunet.py`'s, written
    out again around this encoder). Returns (patchified x, patchified
    reconstruction)."""
    n = cfg["pretrain"]["encoder_stages"]
    x = x.contiguous()  # NCDHW: cuDNN runs a channels-last depthwise conv group by group
    feats = encode(P, cfg, x * upsample_mask(active, x.shape[2:]), active, q)[::-1]
    rec = 0
    for i in range(n - 1):  # one skip per decoder block; the finest feature is unread
        f = feats[i]
        m = upsample_mask(active, f.shape[2:])
        f = instance_norm(f, P[f"densify_norms.{i}.weight"], P[f"densify_norms.{i}.bias"],
                          1e-6, m)
        f = torch.where(m.bool(), f, P[f"mask_tokens.{i}"])
        if f"densify_projs.{i}.weight" in P:
            f = conv(q, f, P[f"densify_projs.{i}.weight"], P[f"densify_projs.{i}.bias"])
        d = f"dense_decoder.dec.{i}"
        y = conv_transpose(q, rec + f, P[f"{d}.up_sample.weight"], P[f"{d}.up_sample.bias"])
        y = conv(q, y, P[f"{d}.conv.0.weight"])
        y = instance_norm(y, P[f"{d}.conv.1.weight"], P[f"{d}.conv.1.bias"]).clamp(0.0, 6.0)
        y = conv(q, y, P[f"{d}.conv.3.weight"])
        rec = instance_norm(y, P[f"{d}.conv.4.weight"], P[f"{d}.conv.4.bias"])
        active = active.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
    rec = conv(q, rec, P["dense_decoder.proj.weight"], P["dense_decoder.proj.bias"])
    fmap = [s >> (n - 1) for s in x.shape[2:]]
    return patchify(x, fmap), patchify(rec, fmap)


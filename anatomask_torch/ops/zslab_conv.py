"""Stride-1 3x3x3 convolution with the z-slab rounding: the hand-written
CUDA kernel, its plain PyTorch version and two autograd Functions. Padding 1
("same") unless the caller passes 0 or 2 (`ops/conv3x3.py` says what each
means).

Replaces the TPU kernel `anatomask_tpu/ops/pallas_zslab_conv.py` `_fwd_impl`
(public `conv3d_zslab`, custom VJP `_fwd_vjp`/`_bwd_vjp`). Layouts are the JAX
package's: x NDHWC, w DHWIO.

It computes the conv of `ops/conv3x3.py` with the TPU kernel's rounding: the
9*C-term partial sum of each tap along the first spatial axis (the TPU
kernel's z-tap) is summed in fp32 and rounded to x's dtype, and the three are
added in x's dtype, tap 0, then + tap 1, then + tap 2. That is the forward
rounding of the JAX package's bf16 main path at >= 32768 output voxels
(`ops/conv_lowering.py` `conv3d_zconcat`, three 2D convs summed in bf16);
`conv3d_3x3` rounds once from fp32. The two Functions differ in dx only:

- `conv3d_zconcat(x, w)`: the main path's conv (`models/layers.py` ConvND at
  >= 32768 output voxels). The forward is the kernel (`csrc/zslab_conv.cu`:
  the implicit GEMM of `csrc/conv3x3_igemm.cuh` that `conv3d_3x3` also runs,
  with its per-tap rounding switched on). dx and dw are `conv3d_3x3`'s:
  kernel #1 on the output gradient with the flipped weight, rounded once,
  and torch's weight-gradient convolution. That is jax.vjp of
  `conv3d_zconcat`, whose dx is one conv over the 3F-channel cotangent.
- `conv3d_zslab(x, w)`: the Pallas kernel's own VJP, for the probe path
  (`probes/probe_pallas_v4.py`): dx is this kernel, per-tap rounded, on the
  output gradient cast to x's dtype with the weight flipped on its three
  spatial axes and C/F swapped, as `_bwd_vjp` does; dw as above.
- `conv3d_zslab_plain(x, w)`: the forward's arithmetic in plain PyTorch. A
  CPU tensor goes through it; a CUDA tensor always launches the kernel, and
  anything the kernel does not take raises.

Unlike the TPU kernel (H % 8 == 0, a 12 MB VMEM budget) there is no shape
gate: any (B, D, H, W, C) with C >= 1, in fp32 or bf16. `conv_variant` of
`ops/conv3x3.py` sends bf16 with C and F multiples of 32 to the kernel's
hopper variant, which rounds each tap in registers, fp32 with C and F
multiples of 32 to its tf32x3 variant (each tap summed in fp32 from three
TF32 products a term, the three taps added in fp32), the stems of both
dtypes (C = 1, 3, 4, ... up to 8, F a multiple of 16 up to 96) to its stem
variant (bf16: each tap rounded in registers; fp32: each tap summed in fp32
on the FP32 pipe, the three added in fp32), and everything else (other
channel counts) to its simple variant. `models/layers.py` ConvND reaches
all four through `conv3d_zconcat`. Bound
on the H100 and the design: the notes at the top of `csrc/zslab_conv.cu`,
`csrc/conv3x3_igemm.cuh` and `csrc/conv3x3_stem.cuh`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as fn

from anatomask_torch.ops.conv3x3 import (Conv3x3Function, check_args, count_launch,
                                         flip_weight, launch_igemm, out_extents, weight_grad,
                                         zero_launch_counts)

_PLAIN_CHUNK_BYTES = 1 << 28  # fp32 im2col slab per matmul in the plain version


def conv3d_zslab_plain(x: torch.Tensor, w: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """x (B, D', H', W', C), w (3, 3, 3, C, F) -> (B, D, H, W, F) in x.dtype,
    each extent the input's + 2 * padding - 2: per tap d of the first axis,
    the 9 (dy, dx) shifted slices times w[d] in fp32, rounded to x.dtype,
    then added in x.dtype in the order d = 0, 1, 2. Chunked over D so that
    the im2col slab stays under 256 MiB."""
    B, C = x.shape[0], x.shape[-1]
    D, H, W = out_extents(x, padding)
    F = w.shape[-1]
    xp = fn.pad(x, (0, 0) + (padding,) * 6)
    w3 = w.reshape(3, 9 * C, F).float()
    out = torch.empty((B, D, H, W, F), dtype=x.dtype, device=x.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * B * H * W * 9 * C))
    for d0 in range(0, D, step):
        d1 = min(D, d0 + step)
        acc = None
        for d in range(3):
            cols = [xp[:, d0 + d:d1 + d, dy:dy + H, dx:dx + W, :]
                    for dy in range(3) for dx in range(3)]
            patches = torch.cat(cols, dim=-1).float().reshape(-1, 9 * C)
            tap = (patches @ w3[d]).to(x.dtype)
            acc = tap if acc is None else acc + tap
        out[:, d0:d1] = acc.reshape(B, d1 - d0, H, W, F)
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    y, variant = launch_igemm(x, w, "zslab_conv", "zslab_forward", padding)
    count_launch(conv3d_zslab, variant, padding)
    return y


def conv3d_zslab_forward(x: torch.Tensor, w: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Forward only: the kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else."""
    check_args(x, w, "conv3d_zslab", padding)
    if x.device.type == "cuda":
        return _launch(x, w, padding)
    if x.device.type == "cpu":
        return conv3d_zslab_plain(x, w, padding)
    raise ValueError(f"conv3d_zslab runs on cuda (kernel) or cpu (plain), not {x.device}")


class ZslabConvFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_zslab_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_zslab_forward(g, flip_weight(w).to(x.dtype))
        if ctx.needs_input_grad[1]:
            dw = weight_grad(g, x, w)
        return dx, dw


def conv3d_zslab(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 'same' 3x3x3 conv with per-tap rounding of the
    forward and of dx (the Pallas kernel's VJP), x NDHWC, w DHWIO."""
    return ZslabConvFunction.apply(x, w)


class ZconcatConvFunction(Conv3x3Function):
    """Forward per tap (this kernel); backward inherited from conv3d_3x3's
    Function: dx rounded once (kernel #1 at padding 2 - padding), dw by
    weight_grad."""

    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return conv3d_zslab_forward(x, w, padding)


def conv3d_zconcat(x: torch.Tensor, w: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Differentiable stride-1 3x3x3 conv rounded as the JAX package's
    `conv3d_zconcat_folded`: the forward per tap, dx once. padding 1 is the
    main path's 'same' conv, padding 0 the block-sparse encoder's VALID conv
    of a halo'd block (whose dx is kernel #1's 'full' conv, padding 2). x
    NDHWC, w DHWIO."""
    return ZconcatConvFunction.apply(x, w, padding)


# kernel launches, in total, by variant and by padding, since the caller last set them to 0
zero_launch_counts(conv3d_zslab)

"""Stride-1 "same" 3x3x3 convolution: the hand-written CUDA kernel, its plain
PyTorch version and its autograd Function.

Replaces the TPU kernel `anatomask_tpu/ops/pallas_conv.py`
`_pallas_conv3d_chunk` (public `conv3d_3x3`, custom VJP `_fwd`/`_bwd`). The
layout at this module's public functions is the JAX package's: activations
NDHWC, weights DHWIO.

- `conv3d_3x3(x, w)`: differentiable. The forward is the kernel
  (`csrc/conv3x3.cu`); dx is the same kernel on the output gradient with the
  weight flipped on its three spatial axes and C/F swapped, as the TPU kernel's
  VJP does. dw is not a product of the kernel: like the TPU kernel, which
  leaves dw to XLA, it goes to torch's weight-gradient convolution.
- `conv3d_3x3_plain(x, w)`: the same arithmetic in plain PyTorch (27 shifted
  slices of the zero-padded input times the (27*C, F) weight, fp32
  accumulation, one rounding). A CPU tensor goes through it; a CUDA tensor
  always launches the kernel, and anything the kernel does not take raises.
- `check_args` and `launch_igemm`: the input checks and the ctypes launch
  shared with `ops/zslab_conv.py`, whose kernel is the same implicit GEMM
  (`csrc/conv3x3_igemm.cuh`) with per-tap rounding.

Bound on the H100: the main path's convs (C, F >= 32, volumes of 7x7x8 up to
112x112x128) do at least 2*27*32 FLOP per byte moved, so the bf16 tensor-core
rate (989 TFLOP/s) bounds them, not the 3.35 TB/s of memory. The kernel is an
implicit GEMM (no im2col tensor in device memory; the halo is masked in the
load) on wmma tensor-core fragments with fp32 accumulators. Its gap to that
bound is measured by chip_smoke.py and kept in PERF.md.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as fn

from anatomask_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_CHUNK_BYTES = 1 << 28  # fp32 im2col slab per matmul in the plain version


def check_args(x: torch.Tensor, w: torch.Tensor, name: str = "conv3d_3x3") -> None:
    """Raise ValueError for what the kernels of csrc/conv3x3_igemm.cuh do not take."""
    if x.dim() != 5:
        raise ValueError(f"{name} expects NDHWC input, got shape {tuple(x.shape)}")
    if w.dim() != 5 or tuple(w.shape[:3]) != (3, 3, 3) or w.shape[3] != x.shape[4]:
        raise ValueError(f"{name} expects a (3, 3, 3, {x.shape[4]}, F) weight, "
                         f"got {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16 of one dtype, got "
                         f"{x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous NDHWC input")


def conv3d_3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, X, Y, Z, C), w (3, 3, 3, C, F) -> (B, X, Y, Z, F) in x.dtype.
    Chunked over X so that the im2col slab stays under 256 MiB."""
    B, X, Y, Z, C = x.shape
    F = w.shape[-1]
    xp = fn.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    w2 = w.reshape(27 * C, F).float()
    out = torch.empty((B, X, Y, Z, F), dtype=x.dtype, device=x.device)
    step = max(1, _PLAIN_CHUNK_BYTES // (4 * B * Y * Z * 27 * C))
    for x0 in range(0, X, step):
        x1 = min(X, x0 + step)
        cols = [xp[:, x0 + dx:x1 + dx, dy:dy + Y, dz:dz + Z, :]
                for dx in range(3) for dy in range(3) for dz in range(3)]
        patches = torch.cat(cols, dim=-1).float().reshape(-1, 27 * C)
        out[:, x0:x1] = (patches @ w2).reshape(B, x1 - x0, Y, Z, F).to(x.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _entry(library: str, symbol: str):
    """The C launcher `symbol` of csrc/<library>.cu, built and loaded at
    first use."""
    f = getattr(_build.load(library), symbol)
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch_igemm(x: torch.Tensor, w: torch.Tensor, library: str, symbol: str) -> torch.Tensor:
    """One launch of a kernel of csrc/conv3x3_igemm.cuh through its C launcher,
    on the current stream of x's device. Counting is the caller's."""
    B, X, Y, Z, C = x.shape
    F = w.shape[-1]
    w2 = w.reshape(27 * C, F).contiguous()
    y = torch.empty((B, X, Y, Z, F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    vec = 16 // x.element_size()
    vec_a = C % vec == 0 and x.data_ptr() % 16 == 0
    vec_b = F % vec == 0 and w2.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry(library, symbol)(x.data_ptr(), w2.data_ptr(), y.data_ptr(), B, X, Y, Z,
                                      C, F, _DTYPE_CODES[x.dtype], int(vec_a), int(vec_b),
                                      stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, F {F}, {x.dtype})")
    return y


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = launch_igemm(x, w, "conv3x3", "conv3x3_forward")
    conv3d_3x3.launches += 1
    return y


def conv3d_3x3_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Forward only: the kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else."""
    check_args(x, w)
    if x.device.type == "cuda":
        return _launch(x, w)
    if x.device.type == "cpu":
        return conv3d_3x3_plain(x, w)
    raise ValueError(f"conv3d_3x3 runs on cuda (kernel) or cpu (plain), not {x.device}")


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, F) -> (3, 3, 3, F, C), flipped on the spatial axes: the
    weight whose 'same' conv of the output gradient is dx."""
    return torch.flip(w, (0, 1, 2)).transpose(3, 4)


def weight_grad(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dw (3, 3, 3, C, F) of the 'same' conv from the output gradient g and
    the input x (both NDHWC): torch's convolution backward, the counterpart of
    the XLA correlation that the TPU kernels' VJPs leave outside them."""
    dw = torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
        w.permute(4, 3, 0, 1, 2), None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
        False, [0, 0, 0], 1, [False, True, False])[1]
    return dw.permute(2, 3, 4, 1, 0).to(w.dtype)


class Conv3x3Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_3x3_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_3x3_forward(g, flip_weight(w).to(g.dtype))
        if ctx.needs_input_grad[1]:
            dw = weight_grad(g, x, w)
        return dx, dw


def conv3d_3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 'same' 3x3x3 conv, x NDHWC, w DHWIO."""
    return Conv3x3Function.apply(x, w)


conv3d_3x3.launches = 0  # kernel launches since the caller last set it to 0

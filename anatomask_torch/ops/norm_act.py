"""The norm epilogue of the no-grad forward in one pass: the conv's bias, the
norm's affine, the residual with its bias, and LeakyReLU, over an NDHWC
activation. The hand-written CUDA kernel (`csrc/norm_act.cu`) and its plain
PyTorch version.

Replaces no TPU kernel: the JAX package leaves these elementwise steps to
XLA, which fuses them into the ops around them. In eager PyTorch each is a
full read and write of the activation (a residual block of the STUNet makes
ten); the kernel makes them one read of the conv's output (and of the
residual) and one write. It serves the forward that autograd does not
record (prediction, the AnatoMask teacher, validation), since a backward
would need the intermediates it never writes; `models/layers.py` picks it.

- `norm_act(y, a, b, bias=None, act=False, skip=None, skip_bias=None)`: y
  (B, X, Y, Z, C) float32 or bfloat16, contiguous; a and b the norm's fp32
  affine, (B, C) or (1, C); bias and skip_bias fp32 (C,) or None; skip a
  tensor like y or None. Returns, in y's dtype,

      act(((y + bias) * a + b) + (skip + skip_bias))

  with bias, a, b and skip_bias rounded to y's dtype and every step rounded
  to it, in the order of the op sequence it replaces (`norm_act_plain`), so
  the two give the same bits; act is LeakyReLU(0.01).
- `norm_act_plain(...)`: that op sequence in plain PyTorch. A CPU tensor goes
  through it; a CUDA tensor always launches the kernel, and anything the
  kernel does not take raises.

Bound on the H100: a few flops a byte, so the 3.35 TB/s of device memory:
2 (3 with a residual) x the activation's bytes a call. The kernel streams
16-byte vectors along C, the per-channel operands held in registers; one
launch a call, nothing allocated but the output. Its time beside the bound
and beside the op sequence is measured by chip_smoke.py and kept in PERF.md.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as fn

from anatomask_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NEGATIVE_SLOPE = 0.01


def _check(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
           skip: Optional[torch.Tensor], skip_bias: Optional[torch.Tensor]) -> None:
    if y.dim() != 5:
        raise ValueError(f"norm_act expects NDHWC input, got shape {tuple(y.shape)}")
    if y.dtype not in _DTYPE_CODES:
        raise ValueError(f"norm_act takes float32 or bfloat16, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("norm_act expects a contiguous NDHWC input")
    B, C = y.shape[0], y.shape[-1]
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] not in (1, B)
                or t.shape[1] != C or not t.is_contiguous()):
            raise ValueError(f"norm_act expects a contiguous float32 (1 or {B}, {C}) {name}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"norm_act: a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    for name, t in (("bias", bias), ("skip_bias", skip_bias)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (C,)
                              or not t.is_contiguous()):
            raise ValueError(f"norm_act expects a contiguous float32 ({C},) {name}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if skip is not None and (skip.shape != y.shape or skip.dtype != y.dtype
                             or not skip.is_contiguous()):
        raise ValueError(f"norm_act expects a contiguous {tuple(y.shape)} {y.dtype} skip, got "
                         f"{tuple(skip.shape)} {skip.dtype}")
    if skip_bias is not None and skip is None:
        raise ValueError("norm_act: a skip_bias without a skip")
    for t in (a, b, bias, skip, skip_bias):
        if t is not None and t.device != y.device:
            raise ValueError(f"norm_act: y on {y.device}, an operand on {t.device}")


def norm_act_plain(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, act: bool = False,
                   skip: Optional[torch.Tensor] = None,
                   skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The op sequence of the model's norm epilogue, in y's dtype dt: y + bias,
    * a, + b, + (skip + skip_bias), LeakyReLU, each rounded to dt."""
    dt = y.dtype
    if bias is not None:
        y = y + bias.to(dt)
    out = y * a.to(dt)[:, None, None, None, :] + b.to(dt)[:, None, None, None, :]
    if skip is not None:
        out = out + (skip if skip_bias is None else skip + skip_bias.to(dt))
    return fn.leaky_relu(out, NEGATIVE_SLOPE) if act else out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("norm_act")
    lib.norm_act_forward.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                                     + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.norm_act_forward.restype = ctypes.c_int
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            act: bool, skip: Optional[torch.Tensor],
            skip_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One launch of the kernel on the current stream of y's device."""
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    B, C = y.shape[0], y.shape[-1]
    V = y.numel() // (B * C)
    vec = int(C % (16 // y.element_size()) == 0
              and all(t.data_ptr() % 16 == 0 for t in (y, out, skip) if t is not None))
    dev = y.device.index
    guard = (contextlib.nullcontext() if dev == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        stream = torch._C._cuda_getCurrentRawStream(dev)  # the current stream's handle
        err = _kernel().norm_act_forward(
            y.data_ptr(), _ptr(bias), a.data_ptr(), b.data_ptr(), _ptr(skip), _ptr(skip_bias),
            out.data_ptr(), B, V, C, a.shape[0], _DTYPE_CODES[y.dtype], vec, int(act), stream)
    if err != 0:
        raise RuntimeError(f"norm_act kernel launch failed with CUDA error {err} (y "
                           f"{tuple(y.shape)}, {y.dtype}, bias {bias is not None}, skip "
                           f"{skip is not None}, skip_bias {skip_bias is not None}, act {act})")
    norm_act.launches += 1
    return out


def norm_act(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None, act: bool = False,
             skip: Optional[torch.Tensor] = None,
             skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """act(((y + bias) * a + b) + (skip + skip_bias)) of an NDHWC y, every step
    rounded to y's dtype as `norm_act_plain` rounds it; forward only. The
    kernel for a CUDA tensor, the plain version for a CPU tensor, an error
    for anything else."""
    _check(y, a, b, bias, skip, skip_bias)
    if y.device.type == "cuda":
        return _launch(y, a, b, bias, act, skip, skip_bias)
    if y.device.type == "cpu":
        return norm_act_plain(y, a, b, bias, act, skip, skip_bias)
    raise ValueError(f"norm_act runs on cuda (kernel) or cpu (plain), not {y.device}")


norm_act.launches = 0  # kernel launches since the caller last set it to 0

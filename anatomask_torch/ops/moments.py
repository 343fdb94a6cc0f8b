"""Per-row fp32 moments of an NDHWC activation, sum(m*x) and sum(m*x^2) per
(sample, channel): the hand-written CUDA kernel, its plain PyTorch version and
its autograd Function. These are the statistics of every instance norm of the
port (`models/layers.py` InstanceNorm, `ssl/sparse.py` SparseInstanceNorm).

Replaces the TPU kernel `probes/probe_rowstats.py` `pallas_moments` (body
`_kern`), the Pallas form of the JAX package's `ops/moments.py`
`folded_row_sums`.

- `row_moments(x, mask=None)`: x (B, X, Y, Z, C) float32 or bfloat16,
  contiguous; mask (B, X, Y, Z) bool or None. Returns fp32 (s, ss), each
  (B, C). Differentiable in x: the backward is elementwise PyTorch,
  dx = (g_s + 2 * x * g_ss) * m, as the JAX package has no backward kernel.
- `row_moments_plain(x, mask=None)`: the same sums in plain PyTorch. A CPU
  tensor goes through it; a CUDA tensor always launches the kernel
  (`csrc/moments.cu`), and anything the kernel does not take raises.

Both widen x to fp32 before squaring, as the TPU kernel does (the shipped
`folded_row_sums` squares in the input dtype: at bf16 the two differ by the
rounding of x*x only).

Bound on the H100: every input byte is read once for 3 flops per element, so
the 3.35 TB/s of device memory bounds it. The kernel streams x once with
16-byte loads along C, keeps the sums in fp32 registers, and finishes with a
deterministic second pass over per-block partials (no atomics). Its gap to
the bound is measured by chip_smoke.py and kept in PERF.md.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from anatomask_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    if x.dim() != 5:
        raise ValueError(f"row_moments expects NDHWC input, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"row_moments takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("row_moments expects a contiguous NDHWC input")
    if mask is None:
        return
    if mask.dtype != torch.bool or tuple(mask.shape) != tuple(x.shape[:4]):
        raise ValueError(f"row_moments expects a {tuple(x.shape[:4])} bool mask, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != x.device:
        raise ValueError(f"x on {x.device}, mask on {mask.device}")
    if not mask.is_contiguous():
        raise ValueError("row_moments expects a contiguous mask")


def row_moments_plain(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, X, Y, Z, C), mask (B, X, Y, Z) or None -> fp32 (sum m*x, sum m*x^2),
    each (B, C); x is widened to fp32 before it is squared."""
    xf = x.float()
    xm = xf if mask is None else xf * mask.unsqueeze(-1)
    return xm.sum((1, 2, 3)), (xm * xf).sum((1, 2, 3))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("moments")
    lib.row_moments_workspace.argtypes = [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3
    lib.row_moments_workspace.restype = ctypes.c_longlong
    lib.row_moments_forward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.row_moments_forward.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both passes of the kernel on the current stream of x's device."""
    B, C = x.shape[0], x.shape[-1]
    if x.numel() == 0:
        zero = torch.zeros((B, C), dtype=torch.float32, device=x.device)
        return zero, zero.clone()
    s = torch.empty((B, C), dtype=torch.float32, device=x.device)
    ss = torch.empty((B, C), dtype=torch.float32, device=x.device)
    V = x.numel() // (B * C)
    code = _DTYPE_CODES[x.dtype]
    vec = int(C % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    lib = _kernel()
    work = torch.empty(lib.row_moments_workspace(B, V, C, code, vec), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.row_moments_forward(x.data_ptr(), None if mask is None else mask.data_ptr(),
                                      s.data_ptr(), ss.data_ptr(), work.data_ptr(), B, V, C,
                                      code, vec, stream)
    if err != 0:
        raise RuntimeError(f"moments kernel launch failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, {x.dtype}, mask {mask is not None})")
    row_moments.launches += 1
    return s, ss


def row_moments_forward(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: the kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else."""
    _check(x, mask)
    if x.device.type == "cuda":
        return _launch(x, mask)
    if x.device.type == "cpu":
        return row_moments_plain(x, mask)
    raise ValueError(f"row_moments runs on cuda (kernel) or cpu (plain), not {x.device}")


class RowMomentsFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask):
        ctx.save_for_backward(x, mask)
        return row_moments_forward(x, mask)

    @staticmethod
    def backward(ctx, g_s, g_ss):
        x, mask = ctx.saved_tensors
        g = g_s[:, None, None, None, :] + 2.0 * x.float() * g_ss[:, None, None, None, :]
        if mask is not None:
            g = g * mask.unsqueeze(-1)
        return g.to(x.dtype), None


def row_moments(x: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fp32 (sum m*x, sum m*x^2) over the voxels of each sample,
    x NDHWC, mask (B, X, Y, Z) bool or None -> two (B, C) tensors."""
    return RowMomentsFunction.apply(x, mask)


row_moments.launches = 0  # kernel launches since the caller last set it to 0

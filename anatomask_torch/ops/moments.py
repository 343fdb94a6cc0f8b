"""Per-row fp32 moments of an NDHWC activation, sum(m*x) and sum(m*x^2) per
(sample, channel): the hand-written CUDA kernel, its plain PyTorch version and
its autograd Function. These are the statistics of every instance norm of the
port (`models/layers.py` InstanceNorm, `ssl/sparse.py` SparseInstanceNorm).

Replaces the TPU kernel `probes/probe_rowstats.py` `pallas_moments` (body
`_kern`), the Pallas form of the JAX package's `ops/moments.py`
`folded_row_sums`.

- `row_moments(x, mask=None, square_in_dtype=False)`: x (B, X, Y, Z, C)
  float32 or bfloat16, contiguous; mask (B, X, Y, Z) bool or None. Returns
  fp32 (s, ss), each (B, C). Differentiable in x: the backward is
  elementwise PyTorch, as the JAX package has no backward kernel.
- `row_moments_forward(x, mask=None, square_in_dtype=False, bias=None)`:
  forward only; with a float32 (C,) `bias` the sums are those of x + bias,
  rounded to x's dtype (the bias rounded to it first), without writing that
  tensor: the no-grad forward's norms, whose conv leaves its bias to them
  (`models/layers.py` InstanceNorm.epilogue).
- `row_moments_plain(x, mask=None, square_in_dtype=False, bias=None)`: the
  same sums in plain PyTorch. A CPU tensor goes through it; a CUDA tensor
  always launches the kernel (`csrc/moments.cu`), and anything the kernel
  does not take raises.

x*x: by default x is widened to fp32 before it is squared, as the TPU kernel
does. With `square_in_dtype=True` x*x is rounded to x's dtype first and then
summed in fp32, as every norm of the JAX package squares in the compute dtype
(`models/layers.py` `jnp.square(x)`, `ssl/sparse.py` `_masked_moments`,
`ops/moments.py` `x * xm`); the model's norms set it. In fp32 the two agree.
The backward follows: dx = (g_s + 2 x g_ss) m in fp32, cast to x's dtype, or
with the flag jax.vjp's bf16 arithmetic, dx = (bf16(g_s) + bf16(bf16(g_ss) *
2x)) m.

Bound on the H100: every input byte is read once for 3 flops per element, so
the 3.35 TB/s of device memory bounds a large call and fixed costs a small
one. The kernel is one launch a call: blocks stream x with 16-byte loads
along C, and the last block of each (sample, channel tile) adds the blocks'
partials in a fixed order (no float atomics). The wrapper allocates only the
(2, B, C) output; the kernel's scratch (partials and integer tickets, which
the kernel leaves at 0) is kept per device and stream and grows when a shape
needs more. The gap to the bound is measured by chip_smoke.py and kept in
PERF.md.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from anatomask_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, mask: Optional[torch.Tensor],
           bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 5:
        raise ValueError(f"row_moments expects NDHWC input, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"row_moments takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("row_moments expects a contiguous NDHWC input")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (x.shape[-1],)
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"row_moments expects a contiguous float32 ({x.shape[-1]},) bias on "
                         f"{x.device}, got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if mask is None:
        return
    if mask.dtype != torch.bool or tuple(mask.shape) != tuple(x.shape[:4]):
        raise ValueError(f"row_moments expects a {tuple(x.shape[:4])} bool mask, got "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if mask.device != x.device:
        raise ValueError(f"x on {x.device}, mask on {mask.device}")
    if not mask.is_contiguous():
        raise ValueError("row_moments expects a contiguous mask")


def row_moments_plain(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                      square_in_dtype: bool = False,
                      bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, X, Y, Z, C), mask (B, X, Y, Z) or None -> fp32 (sum m*x, sum m*x^2),
    each (B, C); x*x in fp32, or rounded to x's dtype with square_in_dtype.
    With a (C,) bias, x is first x + bias in x's dtype."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    xf = x.float()
    sq = (x * x).float() if square_in_dtype else xf * xf
    if mask is not None:
        m = mask.unsqueeze(-1)
        xf, sq = xf * m, sq * m
    return xf.sum((1, 2, 3)), sq.sum((1, 2, 3))


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("moments")
    lib.row_moments_scratch.argtypes = ([ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
                                        + [ctypes.POINTER(ctypes.c_longlong)])
    lib.row_moments_scratch.restype = ctypes.c_int
    lib.row_moments_forward.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.row_moments_forward.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_sizes(device: int, B: int, V: int, C: int, code: int, vec: int,
                   square: int) -> Tuple[int, int]:
    """(fp32 partials, int32 tickets) the kernel needs for this call: its grid
    follows the card's SM count and occupancy, which the library reads."""
    sizes = (ctypes.c_longlong * 2)()
    err = _kernel().row_moments_scratch(B, V, C, code, vec, square, sizes)
    if err != 0:
        raise RuntimeError(f"moments kernel refuses B={B} V={V} C={C} (CUDA error {err})")
    return sizes[0], sizes[1]


_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, partials: int,
             tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch on this device and stream, grown when a call needs
    more. Fresh tickets are zeros; each call leaves them at 0."""
    have = _SCRATCH.get((device.index, stream))
    if have is None or have[0].numel() < partials or have[1].numel() < tickets:
        old_p, old_t = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.empty(max(partials, old_p), dtype=torch.float32, device=device),
                torch.zeros(max(tickets, old_t), dtype=torch.int32, device=device))
        _SCRATCH[(device.index, stream)] = have
    return have


def _launch(x: torch.Tensor, mask: Optional[torch.Tensor], square_in_dtype: bool,
            bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on the current stream of x's device."""
    B, C = x.shape[0], x.shape[-1]
    device = x.device
    out = torch.empty((2, B, C), dtype=torch.float32, device=device)
    if x.numel() == 0:
        return out.zero_().unbind(0)
    V = x.numel() // (B * C)
    code, square = _DTYPE_CODES[x.dtype], int(square_in_dtype)
    vec = int(C % (16 // x.element_size()) == 0 and x.data_ptr() % 16 == 0)
    dev = device.index
    guard = (contextlib.nullcontext() if dev == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        stream = torch._C._cuda_getCurrentRawStream(dev)  # the current stream's handle
        partials, tickets = _scratch(device, stream,
                                     *_scratch_sizes(dev, B, V, C, code, vec, square))
        err = _kernel().row_moments_forward(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), B, V, C, code, vec, square, stream)
    if err != 0:
        raise RuntimeError(f"moments kernel launch failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, {x.dtype}, mask {mask is not None}, "
                           f"bias {bias is not None})")
    row_moments.launches += 1
    return out.unbind(0)


def row_moments_forward(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        square_in_dtype: bool = False,
                        bias: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: the kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else. A float32 (C,) `bias` is added to x,
    in x's dtype, before the sums."""
    _check(x, mask, bias)
    if x.device.type == "cuda":
        return _launch(x, mask, square_in_dtype, bias)
    if x.device.type == "cpu":
        return row_moments_plain(x, mask, square_in_dtype, bias)
    raise ValueError(f"row_moments runs on cuda (kernel) or cpu (plain), not {x.device}")


class RowMomentsFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, square_in_dtype):
        ctx.save_for_backward(x, mask)
        ctx.square_in_dtype = square_in_dtype
        return row_moments_forward(x, mask, square_in_dtype)

    @staticmethod
    def backward(ctx, g_s, g_ss):
        x, mask = ctx.saved_tensors
        g_s, g_ss = g_s[:, None, None, None, :], g_ss[:, None, None, None, :]
        if ctx.square_in_dtype:
            # jax.vjp of sum(x) and sum(square(x)) taken in fp32 of x's dtype
            g = g_s.to(x.dtype) + g_ss.to(x.dtype) * (2 * x)
        else:
            g = (g_s + 2.0 * x.float() * g_ss).to(x.dtype)
        if mask is not None:
            g = g * mask.unsqueeze(-1)
        return g, None, None


def row_moments(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                square_in_dtype: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fp32 (sum m*x, sum m*x^2) over the voxels of each sample,
    x NDHWC, mask (B, X, Y, Z) bool or None -> two (B, C) tensors; x*x is
    rounded to x's dtype before the sum with square_in_dtype."""
    return RowMomentsFunction.apply(x, mask, square_in_dtype)


row_moments.launches = 0  # kernel launches since the caller last set it to 0

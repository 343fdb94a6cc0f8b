"""Stride-1 3x3x3 convolution: the hand-written CUDA kernel, its plain
PyTorch version and its autograd Function.

Replaces the TPU kernel `anatomask_tpu/ops/pallas_conv.py`
`_pallas_conv3d_chunk` (public `conv3d_3x3`, custom VJP `_fwd`/`_bwd`). The
layout at this module's public functions is the JAX package's: activations
NDHWC, weights DHWIO.

- `conv3d_3x3(x, w, padding=1)`: differentiable. The forward is the kernel
  (`csrc/conv3x3.cu`); dx is the same kernel on the output gradient with the
  weight flipped on its three spatial axes and C/F swapped, as the TPU kernel's
  VJP does, at padding 2 - padding. dw is not a product of the kernel: like
  the TPU kernel, which leaves dw to XLA, it goes to torch's weight-gradient
  convolution.
- `conv3d_3x3_plain(x, w, padding=1)`: the same arithmetic in plain PyTorch
  (27 shifted slices of the zero-padded input times the (27*C, F) weight,
  fp32 accumulation, one rounding). A CPU tensor goes through it; a CUDA
  tensor always launches the kernel, and anything the kernel does not take
  raises.
- `check_args`, `conv_variant` (with `igemm_variant`, its form for
  tensors), `igemm_tile`, `pack_weight` and `launch_igemm`: the input
  checks, the variant and tile choice, the weight layout and the ctypes
  launch shared with `ops/zslab_conv.py`, whose kernels are the same
  (`csrc/conv3x3_igemm.cuh`, `csrc/conv3x3_stem.cuh`) with per-tap rounding.

`padding` p is 0, 1 or 2 on every side: output voxel o reads input voxels
o + t - p, so an output extent is the input's + 2p - 2. p = 1 is the "same"
conv of the dense paths; p = 0 the VALID conv of a halo'd block and p = 2 its
dx (the block-sparse encoder, `ops/block_sparse.py`).

Bound on the H100: the paths' convs (C, F >= 32, volumes of 7x7x8 up to
128^3) do at least 2*27*32 FLOP per byte moved, so the bf16 tensor-core rate
(989 TFLOP/s, reachable only through wgmma) bounds them, not the 3.35 TB/s of
memory, and in fp32 three TF32 products a term at 495 TFLOP/s (the FP32
pipe's 67 TFLOP/s is slower); the stems (C = 1, 3, 4) do at most 96 FLOP a
byte and are bound by the bytes they write (in fp32 at C = 1 too, on the
FP32 pipe). There are four variants, and
`conv_variant` picks one from dtype, C, F and alignment alone (a shape
dispatch between hand-written kernels; a failed build or launch raises):

- "hopper" (`csrc/conv3x3_igemm.cuh`): bf16 with C and F multiples of 32 and
  16-byte-aligned data, i.e. every conv of the paths but the stems. The
  weight is repacked K-major, (F, 27*C); 128 x BN output tiles (BN = 128, 64
  or 32, the largest dividing F), K steps of BK = 64 (C % 64 == 0) or 32, a
  4-stage cp.async ring feeding wgmma, the address math hoisted out of the K
  loop.
- "stem" (`csrc/conv3x3_stem.cuh`): bf16 or fp32 with 1 <= C <=
  STEM_MAX_C and F a multiple of 16 up to STEM_MAX_F, i.e. every network's
  first conv (C = 1, 3, 4 -> 32; STUNet-H's 1 -> 96). A persistent block
  loads a brick of the input into shared memory once and keeps the weight
  there (`pack_weight`: per first-axis tap K = (dy, dz, c) zero-padded to a
  multiple of 16, one layout for both dtypes); bf16 multiplies on wgmma (A
  from registers), fp32 on the FP32 pipe (each thread 4 z voxels by 8
  channels, the weight read as warp broadcasts). The launcher picks the
  kernel by dtype; each output byte is written once.
- "tf32x3" (`csrc/conv3x3_igemm.cuh`): fp32 with C and F multiples of 32
  and 16-byte-aligned data, i.e. every fp32 conv of the paths but the stems.
  The hopper variant's ring on TF32 wgmma, each product as three (a_lo*b_hi
  + a_hi*b_lo + a_hi*b_hi, hi = the operand rounded to TF32, lo = the rest
  rounded to TF32): the weight comes as two (F, 27*C) planes, hi and lo
  (`pack_weight`), each thread splits its fragments of the fp32 im2col tile
  in registers (wgmma with A from registers). 128 x BN output tiles (BN = 64
  where it divides F, else 32; `tf32_tile`); every 32 channels of K are
  added to the sum in fp32.
- "simple" (`csrc/conv3x3_igemm.cuh`): everything else (other channel
  counts, unaligned wide convs; no path launches it): 64 x 64 tiles on wmma
  fragments (bf16) or FMA (fp32), one shared-memory stage.

Each wrapper counts its launches in total (`launches`), by variant
(`launches_by_variant`) and by padding (`launches_by_padding`). Their gap to
the bound is measured by chip_smoke.py and kept in PERF.md.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as fn

from anatomask_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_CHUNK_BYTES = 1 << 28  # fp32 im2col slab per matmul in the plain version


PADDINGS = (0, 1, 2)


def out_extents(x: torch.Tensor, padding: int) -> tuple[int, int, int]:
    """The output's spatial extents of a 3x3x3 conv of x (NDHWC) at `padding`."""
    return tuple(n + 2 * padding - 2 for n in x.shape[1:4])


def check_args(x: torch.Tensor, w: torch.Tensor, name: str = "conv3d_3x3",
               padding: int = 1) -> None:
    """Raise ValueError for what the kernels of csrc/conv3x3_igemm.cuh do not take."""
    if x.dim() != 5:
        raise ValueError(f"{name} expects NDHWC input, got shape {tuple(x.shape)}")
    if padding not in PADDINGS or min(out_extents(x, padding)) <= 0:
        raise ValueError(f"{name} takes padding 0, 1 or 2 with a non-empty output, got "
                         f"padding {padding!r} for input {tuple(x.shape)}")
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


def conv3d_3x3_plain(x: torch.Tensor, w: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """x (B, X', Y', Z', C), w (3, 3, 3, C, F) -> (B, X, Y, Z, F) in x.dtype,
    each extent the input's + 2 * padding - 2. Chunked over X so that the
    im2col slab stays under 256 MiB."""
    B, C = x.shape[0], x.shape[-1]
    X, Y, Z = out_extents(x, padding)
    F = w.shape[-1]
    xp = fn.pad(x, (0, 0) + (padding,) * 6)
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


VARIANTS = ("hopper", "stem", "tf32x3", "simple")
# the (BK, BN) tiles of the hopper variant: CONV3X3_HOPPER_TILES in csrc/conv3x3_igemm.cuh
HOPPER_TILES = ((32, 32), (32, 64), (32, 128), (64, 32), (64, 64), (64, 128))
# the BN of the tf32x3 variant: CONV3X3_TF32X3_TILES in csrc/conv3x3_igemm.cuh
TF32_TILES = (32, 64)
# the stem variant's domain: CONV3X3_STEM_CHANNELS and MAX_F in csrc/conv3x3_stem.cuh
STEM_MAX_C, STEM_MAX_F = 8, 96


def conv_variant(dtype: torch.dtype, C: int, F: int, aligned: bool = True) -> str:
    """The variant that runs a conv of C -> F channels in `dtype` (`aligned`:
    x starts on a 16-byte boundary; the weight and the output are fresh
    allocations): "hopper" for bf16 with C and F multiples of 32, aligned;
    "tf32x3" for fp32 with C and F multiples of 32, aligned; "stem" for
    either dtype with 1 <= C <= STEM_MAX_C and F a multiple of 16 up to
    STEM_MAX_F (aligned or not: bf16 copies x by words where x's alignment
    allows, else two bytes at a time; fp32 by 4-byte words); else
    "simple"."""
    if C % 32 == 0 and F % 32 == 0 and aligned:
        return "hopper" if dtype == torch.bfloat16 else "tf32x3"
    if 1 <= C <= STEM_MAX_C and F % 16 == 0 and 16 <= F <= STEM_MAX_F:
        return "stem"
    return "simple"


def igemm_variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """conv_variant for the conv of x (NDHWC) by w (DHWIO)."""
    return conv_variant(x.dtype, x.shape[-1], w.shape[-1], x.data_ptr() % 16 == 0)


def igemm_tile(C: int, F: int) -> tuple[int, int]:
    """(BK, BN) of the hopper variant: BK = 64 where it divides C, else 32; BN
    the largest of 128, 64 and 32 that divides F."""
    return (64 if C % 64 == 0 else 32,
            next(bn for bn in (128, 64, 32) if F % bn == 0))


def tf32_tile(F: int) -> int:
    """BN of the tf32x3 variant: 64 where it divides F, else 32."""
    return 64 if F % 64 == 0 else 32


def tf32_split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 v -> (hi, lo): hi = v rounded to the nearest TF32 value (ties
    away from zero, as cvt.rna.tf32.f32: the low 13 bits cleared), lo = v - hi
    rounded the same way."""
    def rna(t):
        return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    v = v.contiguous()
    hi = rna(v)
    return hi, rna(v - hi)


def stem_rows(C: int) -> tuple[int, int]:
    """(R, KT) of the stem variant: the weight rows of one (dx, dy), 3*C
    rounded up to even, and of one first-axis tap, 3*R rounded up to a
    multiple of 16 (Geo<C> in csrc/conv3x3_stem.cuh)."""
    R = 3 * C + C % 2
    return R, -(-3 * R // 16) * 16


def pack_weight(w: torch.Tensor, variant: str) -> torch.Tensor:
    """The (3, 3, 3, C, F) weight as the variant's kernel reads it: (F, 27*C)
    with K = (tap, c) contiguous for "hopper"; the same split into its TF32
    hi and lo planes (tf32_split), (2, F, 27*C), for "tf32x3"; (27*C, F) for
    "simple"; and (F, 3 * KT) with K contiguous for "stem", in bf16 and fp32
    alike: per first-axis tap dx, KT columns (dy, dz, c), column dx * KT + dy
    * R + dz * C + c, the rest zero (stem_rows). The fp32 stem kernel copies
    its real columns into shared memory by (channel group, tap, c)."""
    C, F = w.shape[3], w.shape[4]
    if variant == "stem":
        R, KT = stem_rows(C)
        out = w.new_zeros(F, 3, KT)
        taps = w.reshape(3, 3, 3 * C, F).permute(3, 0, 1, 2)  # (F, dx, dy, (dz, c))
        out[:, :, :3 * R].view(F, 3, 3, R)[..., :3 * C] = taps
        return out.reshape(F, 3 * KT)
    w2 = w.reshape(27 * C, F)
    if variant == "tf32x3":
        return torch.stack(tf32_split(w2.t()))
    return (w2.t() if variant == "hopper" else w2).contiguous()


@functools.lru_cache(maxsize=None)
def _entry(library: str, symbol: str, n_ints: int):
    """The C launcher `symbol` of csrc/<library>.cu, built and loaded at
    first use: three pointers, n_ints ints, the stream."""
    f = getattr(_build.load(library), symbol)
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def launch_igemm(x: torch.Tensor, w: torch.Tensor, library: str, symbol: str,
                 padding: int = 1) -> tuple[torch.Tensor, str]:
    """One launch of a kernel of csrc/conv3x3_igemm.cuh or csrc/conv3x3_stem.cuh
    through the C launcher `symbol` (simple variant), `symbol`_hopper,
    `symbol`_tf32x3 or `symbol`_stem, as igemm_variant picks, on the current
    stream of x's device. Returns the output and the variant; counting is the
    caller's."""
    B, X, Y, Z, C = x.shape
    F = w.shape[-1]
    variant = igemm_variant(x, w)
    w2 = pack_weight(w, variant)
    y = torch.empty((B, *out_extents(x, padding), F), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y, variant
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == "hopper":
            err = _entry(library, f"{symbol}_hopper", 9)(
                x.data_ptr(), w2.data_ptr(), y.data_ptr(), B, X, Y, Z, C, F, padding,
                *igemm_tile(C, F), stream)
        elif variant == "tf32x3":
            err = _entry(library, f"{symbol}_tf32x3", 8)(
                x.data_ptr(), w2.data_ptr(), y.data_ptr(), B, X, Y, Z, C, F, padding,
                tf32_tile(F), stream)
        elif variant == "stem":
            err = _entry(library, f"{symbol}_stem", 8)(
                x.data_ptr(), w2.data_ptr(), y.data_ptr(), B, X, Y, Z, C, F, padding,
                _DTYPE_CODES[x.dtype], stream)
        else:
            vec = 16 // x.element_size()
            vec_a = C % vec == 0 and x.data_ptr() % 16 == 0
            vec_b = F % vec == 0 and w2.data_ptr() % 16 == 0
            err = _entry(library, symbol, 10)(
                x.data_ptr(), w2.data_ptr(), y.data_ptr(), B, X, Y, Z, C, F, padding,
                _DTYPE_CODES[x.dtype], int(vec_a), int(vec_b), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} ({variant}) kernel launch failed with CUDA error {err} "
                           f"(x {tuple(x.shape)}, F {F}, padding {padding}, {x.dtype})")
    return y, variant


def count_launch(fn, variant: str, padding: int) -> None:
    fn.launches += 1
    fn.launches_by_variant[variant] += 1
    fn.launches_by_padding[padding] += 1


def zero_launch_counts(fn) -> None:
    """Set a conv wrapper's launch counts, total, by variant and by padding, to 0."""
    fn.launches = 0
    fn.launches_by_variant = dict.fromkeys(VARIANTS, 0)
    fn.launches_by_padding = dict.fromkeys(PADDINGS, 0)


def _launch(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    y, variant = launch_igemm(x, w, "conv3x3", "conv3x3_forward", padding)
    count_launch(conv3d_3x3, variant, padding)
    return y


def conv3d_3x3_forward(x: torch.Tensor, w: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Forward only: the kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else."""
    check_args(x, w, padding=padding)
    if x.device.type == "cuda":
        return _launch(x, w, padding)
    if x.device.type == "cpu":
        return conv3d_3x3_plain(x, w, padding)
    raise ValueError(f"conv3d_3x3 runs on cuda (kernel) or cpu (plain), not {x.device}")


def flip_weight(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, C, F) -> (3, 3, 3, F, C), flipped on the spatial axes: the
    weight whose conv of the output gradient at padding 2 - p is the dx of
    the conv at padding p."""
    return torch.flip(w, (0, 1, 2)).transpose(3, 4)


def weight_grad(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                padding: int = 1) -> torch.Tensor:
    """dw (3, 3, 3, C, F) of the conv at `padding` from the output gradient g
    and the input x (both NDHWC): torch's convolution backward, the
    counterpart of the XLA correlation that the TPU kernels' VJPs leave
    outside them."""
    dw = torch.ops.aten.convolution_backward(
        g.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3),
        w.permute(4, 3, 0, 1, 2), None, [1, 1, 1], [padding] * 3, [1, 1, 1],
        False, [0, 0, 0], 1, [False, True, False])[1]
    return dw.permute(2, 3, 4, 1, 0).to(w.dtype)


class Conv3x3Function(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, padding):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return conv3d_3x3_forward(x, w, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_3x3_forward(g, flip_weight(w).to(g.dtype), 2 - ctx.padding)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(g, x, w, ctx.padding)
        return dx, dw, None


def conv3d_3x3(x: torch.Tensor, w: torch.Tensor, padding: int = 1) -> torch.Tensor:
    """Differentiable stride-1 3x3x3 conv at `padding` (1: 'same'), x NDHWC,
    w DHWIO."""
    return Conv3x3Function.apply(x, w, padding)


# kernel launches, in total, by variant and by padding, since the caller last set them to 0
zero_launch_counts(conv3d_3x3)

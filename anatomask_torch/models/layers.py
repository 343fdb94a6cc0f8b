"""Shared layers: 3D conv with torch k//2 padding, InstanceNorm and BatchNorm
with fp32 statistics from the moments kernel, the k = s transposed conv,
LeakyReLU, nearest upsampling, and `run_remat` (activation checkpointing of
one module). Counterpart of anatomask_tpu/models/layers.py.

Activations are NCDHW in `torch.channels_last_3d` memory (NDHWC underneath),
so the 3x3x3 kernel gets a contiguous NDHWC view by a free permute.

Rounding follows the JAX model at bf16: conv inputs and weights are cast to
the compute dtype and the bias is added in it. A 3x3x3 conv with at least
MIN_VOLUME output voxels a sample is rounded per tap of the first spatial
axis, as the JAX package's `conv3d_zconcat` (stride 1) and `conv3d_z2d`
(stride 2 along that axis) lowerings round it; smaller ones, 1x1x1 and
anisotropic kernels are rounded once from fp32, as `lax` rounds them. Norm
statistics are fp32 sums of x and of x*x squared in the compute dtype; the
affine is applied in the compute dtype. No autocast.

Where autograd records nothing (prediction, the AnatoMask teacher,
validation), a norm's epilogue runs as one pass of `ops/norm_act.py`: the
conv before it leaves its bias to the norm (`ConvND.without_bias`), whose
moments add it on the fly, and the affine, the residual with its bias and
LeakyReLU follow in the same pass (`InstanceNorm.epilogue`, `fused`).
Each step rounds as the op sequence does, so both routes give the same bits.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as fn
import torch.utils.checkpoint

from anatomask_torch.ops.conv3x3 import conv3d_3x3
from anatomask_torch.ops.moments import row_moments, row_moments_forward
from anatomask_torch.ops.norm_act import norm_act
from anatomask_torch.ops.zslab_conv import conv3d_zconcat
from anatomask_torch.parallel import mesh

CL3D = torch.channels_last_3d
# output voxels a sample from which a 3x3x3 conv is rounded per tap
# (anatomask_tpu/ops/conv_lowering.py _MIN_VOLUME)
MIN_VOLUME = 32768
# compute dtypes of the one-pass norm epilogue (ops/norm_act.py)
FUSED_DTYPES = (torch.bfloat16, torch.float32)


def fused(module: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether `module`'s norm epilogue on input x runs as one pass
    (`InstanceNorm.epilogue`): autograd records nothing there (no grad mode,
    or neither x nor a parameter requires grad) and the compute dtype is
    bf16 or fp32. Elsewhere the op sequence runs, with its autograd."""
    return dtype in FUSED_DTYPES and not (
        torch.is_grad_enabled()
        and (x.requires_grad or any(p.requires_grad for p in module.parameters())))


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


def conv3d_z2d(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int, int]) -> torch.Tensor:
    """3x3x3 conv, padding 1, stride[0] > 1, of an NCDHW x with w (F, C, 3,
    3, 3), as the JAX package's `conv3d_z2d`: one (1, 3, 3) conv a tap of the
    first spatial axis, each rounded to x's dtype, added in it in the order
    0, 1, 2. Tap dz reads input plane stride[0] * o + dz - 1: a conv with
    depth padding p = (1 - dz) mod stride[0] yields it at output plane o +
    (dz - 1 + p) / stride[0], so no tap copies a slab of x. Autograd then
    rounds dx per tap too, as jax.vjp of `conv3d_z2d` does. Library code: no
    TPU kernel is involved."""
    sz = stride[0]
    out_z = (x.shape[2] - 1) // sz + 1
    y = None
    for dz in range(3):
        p = (1 - dz) % sz
        shift = (dz - 1 + p) // sz
        tap = fn.conv3d(x, w[:, :, dz:dz + 1], None, stride, (p, 1, 1))[:, :, shift:shift + out_z]
        y = tap if y is None else y + tap
    return y


class ConvND(nn.Module):
    """3D conv, kernel k, stride s (an int or one per axis), torch padding
    k//2, with the JAX package's `pick_lowering` rounding:

    - stride-1 3x3x3: `conv3d_zconcat` (per-tap forward, kernel #2; dx once,
      kernel #1) at >= MIN_VOLUME output voxels a sample, else `conv3d_3x3`
      (kernel #1, rounded once);
    - 3x3x3 strided along the first axis, at >= MIN_VOLUME output voxels:
      `conv3d_z2d` (three `F.conv3d`, per tap);
    - grouped convs (MedNeXt's depthwise 7x7x7 ones): `GroupedConv`, one
      `F.conv3d` of an NCDHW-contiguous copy of x, so that PyTorch runs its
      depthwise kernels (`conv_depthwise3d_*`); a channels_last_3d x would go
      to cuDNN, which runs these convs as a loop of kernels over the groups
      (2.4 times the MedNeXt step's time on the H100);
    - everything else (smaller strided convs, 1x1x1, anisotropic kernels, and
      3x3x3 strided on the last two axes only, which no model here has): one
      `F.conv3d`, as plain convs the JAX package leaves to XLA.

    Parameters `weight` (O, I / groups, *k) and `bias` as in torch's Conv3d."""

    def __init__(self, cin: int, cout: int, kernel_size: Union[int, Sequence[int]],
                 stride: Union[int, Sequence[int]] = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32, init: str = "he",
                 generator: Optional[torch.Generator] = None, groups: int = 1):
        super().__init__()
        self.kernel_size, self.stride = _triple(kernel_size), _triple(stride)
        self.dtype, self.groups = dtype, groups
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        with torch.no_grad():
            (he_normal_ if init == "he" else trunc_normal_)(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.without_bias(x)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).view(1, -1, 1, 1, 1)
        return y

    def without_bias(self, x: torch.Tensor) -> torch.Tensor:
        """The conv of x in the compute dtype, its bias not added."""
        w = self.weight.to(self.dtype)
        if self.groups != 1:
            return GroupedConv.apply(x.to(self.dtype), w, self.stride,
                                     tuple(k // 2 for k in self.kernel_size), self.groups)
        x = x.to(self.dtype).contiguous(memory_format=CL3D)
        out = math.prod((n - 1) // s + 1 for n, s in zip(x.shape[2:], self.stride))
        k3 = self.kernel_size == (3, 3, 3)
        per_tap = k3 and out >= MIN_VOLUME
        if k3 and self.stride == (1, 1, 1):
            conv = conv3d_zconcat if per_tap else conv3d_3x3
            y = conv(x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0)).permute(0, 4, 1, 2, 3)
        elif per_tap and self.stride[0] > 1:
            y = conv3d_z2d(x, w, self.stride)
        else:
            y = fn.conv3d(x, w, None, self.stride, tuple(k // 2 for k in self.kernel_size))
        return y


class GroupedConv(torch.autograd.Function):
    """A grouped conv, `F.conv3d` of an NCDHW-contiguous copy of x, that
    saves x as it came: PyTorch runs its depthwise kernels
    (`conv_depthwise3d_*`) on a contiguous input. The backward makes the
    copy again, so that a MedNeXt down block, whose residual conv saves the
    same channels_last_3d x, holds it once and not twice."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.args = (stride, padding, groups)
        return fn.conv3d(x.contiguous(), w, None, stride, padding, groups=groups)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.args
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x.contiguous(), w, None, stride, padding, (1, 1, 1), False, (0, 0, 0), groups,
            (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return dx, dw, None, None, None


class InstanceNorm(nn.Module):
    """torch InstanceNorm3d(affine=True) semantics, eps 1e-5, fp32
    statistics from the moments kernel (`row_moments`, x*x squared in x's
    dtype as the JAX norm squares it), affine a*x+b applied in the compute
    dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def sums(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """fp32 (sum v, sum v^2), each (B, C), of v = x, or with an fp32
        (C,) `bias` (forward only) v = x + bias in x's dtype, and the voxels
        each sums over."""
        xn = x.permute(0, 2, 3, 4, 1)
        s, ss = (row_moments(xn, square_in_dtype=True) if bias is None
                 else row_moments_forward(xn, square_in_dtype=True, bias=bias))
        return s, ss, float(math.prod(x.shape[2:]))

    def affine(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (a, b), each (B or 1, C): the norm of v (`sums`) is a * v + b."""
        s, ss, cnt = self.sums(x, bias)
        mean = s / cnt
        var = (ss / cnt - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + self.eps) * self.weight.float()
        return a, self.bias.float() - mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous(memory_format=CL3D)
        if x.dtype == self.dtype and fused(self, x, self.dtype):
            return self.epilogue(x)
        a, b = self.affine(x)
        dt = self.dtype
        return x.to(dt) * a.to(dt)[:, :, None, None, None] + b.to(dt)[:, :, None, None, None]

    def epilogue(self, y: torch.Tensor, bias: Optional[torch.Tensor] = None, act: bool = False,
                 skip: Optional[torch.Tensor] = None,
                 skip_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward only, y in the compute dtype: act(norm(y + bias) + skip +
        skip_bias), act LeakyReLU, each step rounded to the compute dtype as
        the op sequence rounds it: the moments add the bias on the fly, the
        rest is one pass of `ops/norm_act.py`."""
        y = y.contiguous(memory_format=CL3D)
        bias, skip_bias = (None if t is None else t.float() for t in (bias, skip_bias))
        a, b = self.affine(y, bias)
        if skip is not None:
            skip = skip.contiguous(memory_format=CL3D).permute(0, 2, 3, 4, 1)
        out = norm_act(y.permute(0, 2, 3, 4, 1), a, b, bias, act, skip, skip_bias)
        return out.permute(0, 4, 1, 2, 3)


class BatchNorm(InstanceNorm):
    """The JAX package's BatchNorm: training-mode statistics over the batch
    and the voxels, whatever the batch (no running averages), eps 1e-5, as
    InstanceNorm otherwise. The moments kernel sums each (sample, channel)
    with x*x squared in x's dtype; the samples' sums are added in fp32, then
    across the ranks of a process group (JAX's SyncBN under the mesh), with
    the voxel count: every rank holds a batch of one size. `cross_rank` False
    keeps the statistics to the rank's batch (a prediction network, whose
    ranks predict different cases)."""

    cross_rank = True

    def sums(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, float]:
        s, ss, cnt = super().sums(x, bias)
        s, ss, cnt = s.sum(0, keepdim=True), ss.sum(0, keepdim=True), cnt * x.shape[0]
        if self.cross_rank and mesh.distributed():
            s, ss = mesh.all_reduce_sum(torch.cat([s, ss], 1)).chunk(2, 1)
            cnt *= mesh.world()
        return s, ss, cnt


class SubpixelConvTranspose(nn.Module):
    """Transposed conv with kernel == stride, the JAX package's
    SubpixelConvTranspose (`ops/subpixel.py` `conv_transpose_k_eq_s`): each
    output voxel depends on one input voxel, so it is one matmul of x by the
    (C, s1*s2*s3*F) weight, a pixel shuffle, and the bias added in the
    compute dtype. Library code: no TPU kernel is involved.

    `weight` is (C, F, s1, s2, s3), torch ConvTranspose3d's layout, and
    `bias` (F,); the kernel is applied mirrored, as the JAX one is
    (out[s*m + r] = x[m] @ weight[:, :, s-1-r]), so that the JAX package's
    torch adapters carry the weight across unchanged."""

    def __init__(self, cin: int, cout: int, stride: Union[int, Sequence[int]],
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.dtype = _triple(stride), dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, *self.stride))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():  # He normal over the JAX kernel's fan-in, C * s1*s2*s3
            std = math.sqrt(2.0 / (1.0 + 1e-4) / (cin * math.prod(self.stride)))
            nn.init.normal_(self.weight, 0.0, std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        B, C, D, H, W = x.shape
        s1, s2, s3 = self.stride
        F = self.weight.shape[1]
        # (C, phase-major s1*s2*s3*F) of the mirrored kernel
        w1 = self.weight.to(dt).flip(2, 3, 4).permute(0, 2, 3, 4, 1).reshape(C, -1)
        xn = x.to(dt).contiguous(memory_format=CL3D).permute(0, 2, 3, 4, 1)
        phases = (xn.reshape(-1, C) @ w1).view(B, D, H, W, s1, s2, s3, F)
        shuffled = phases.permute(0, 1, 4, 2, 5, 3, 6, 7)
        if torch.is_grad_enabled() and (shuffled.requires_grad or self.bias.requires_grad):
            # training: autograd takes no out= argument (one copy more)
            y = shuffled.reshape(B, D * s1, H * s2, W * s3, F) + self.bias.to(dt)
            return y.permute(0, 4, 1, 2, 3)
        y = torch.empty((B, D, s1, H, s2, W, s3, F), dtype=dt, device=x.device)
        torch.add(shuffled, self.bias.to(dt), out=y)
        return y.view(B, D * s1, H * s2, W * s3, F).permute(0, 4, 1, 2, 3)


def run_remat(remat: bool, module: nn.Module, *args):
    """module(*args), with `remat` under activation checkpointing (the JAX
    package's nn.remat): where autograd records, the module's activations are
    dropped after its forward and recomputed, kernels and all, when the
    backward reaches it."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(module, *args, use_reentrant=False)
    return module(*args)


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

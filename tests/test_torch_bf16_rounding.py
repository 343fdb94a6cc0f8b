"""The port's bf16 rounding against the JAX package's on the CPU: the 3x3x3
convs of `models/layers.py` ConvND, rounded per first-axis tap from 32768
output voxels a sample (JAX's `pick_lowering`: `conv3d_zconcat` at stride 1,
`conv3d_z2d` at stride 2) and once below; the instance norms, whose x*x is
squared in bf16; and a tiny SparK forward loss. Inputs come from numpy seeds
and go to both as the same bf16 values.

A relative error cannot tell one rounding from another (they differ by about
one bf16 ulp), so each case counts the elements bit-equal to JAX's. Where
an fp32 sum is taken in another order than JAX's, an element can round one
ulp apart: hence shares, not equality."""
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as fn

from anatomask_tpu.models import layers as jl
from anatomask_tpu.ssl import spark as js
from anatomask_tpu.ssl import sparse as jsp
from anatomask_torch.models import layers as tl
from anatomask_torch.ops.conv3x3 import conv3d_3x3_plain, flip_weight
from anatomask_torch.ops.moments import row_moments
from anatomask_torch.ops.zslab_conv import conv3d_zslab_plain
from anatomask_torch.ssl import spark as ts
from anatomask_torch.ssl import sparse as tsp

from torch_parity import (jax_build_spark_model, jax_random_params, mask_nd, mask_port,
                          port_model, random_keep, tiny_configs, to_ncdhw)

C = F = 8


def bf16(a) -> np.ndarray:
    """float32 numpy values rounded to bf16 (as float32)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def to_port(a: np.ndarray, requires_grad=False) -> torch.Tensor:
    """NDHWC numpy -> bf16 NCDHW tensor in channels_last_3d memory."""
    t = torch.from_numpy(np.ascontiguousarray(a)).permute(0, 4, 1, 2, 3)
    t = t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    return t.requires_grad_(requires_grad)


def to_ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 4, 1).float().numpy()


def share(a: np.ndarray, b: np.ndarray) -> float:
    assert a.shape == b.shape
    return float(np.mean(a == b))


def conv_case(stride, n):
    rs = np.random.RandomState(100 * stride + n)
    x = bf16(rs.randn(1, n, n, n, C))
    w = bf16(rs.randn(3, 3, 3, C, F) * np.sqrt(2.0 / (27 * C)))
    b = (0.1 * rs.randn(F)).astype(np.float32)
    out = (n - 1) // stride + 1
    g = bf16(rs.randn(1, out, out, out, F))
    return x, w, b, g


def jax_conv(x, w, b, g, stride):
    mod = jl.ConvND(features=F, kernel_size=(3, 3, 3), strides=(stride,) * 3,
                    dtype=jnp.bfloat16)
    params = {"params": {"conv": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}}
    y, vjp = jax.vjp(lambda xx, p: mod.apply(p, xx), jnp.asarray(x, jnp.bfloat16), params)
    dx, dp = vjp(jnp.asarray(g, jnp.bfloat16))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return f32(y), f32(dx), f32(dp["params"]["conv"]["kernel"])


def port_conv(x, w, b, g, stride):
    conv = tl.ConvND(C, F, 3, stride, dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
        conv.bias.copy_(torch.from_numpy(b))
    xt = to_port(x, True)
    y = conv(xt)
    y.backward(to_port(g))
    return to_ndhwc(y), to_ndhwc(xt.grad), conv.weight.grad.permute(2, 3, 4, 1, 0).numpy()


def other_rounding(x, w, b, g, stride, per_tap):
    """The forward and dx of the route the port must not take here: per-tap
    (kernel #2's Function, or three taps at stride 2) or once-rounded (one
    conv) throughout."""
    xt, gt = to_port(x, True), to_port(g)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    bt = torch.from_numpy(b).to(torch.bfloat16).view(1, -1, 1, 1, 1)
    if stride == 1:
        conv = conv3d_zslab_plain if per_tap else conv3d_3x3_plain
        y = conv(xt.detach().permute(0, 2, 3, 4, 1), wt).permute(0, 4, 1, 2, 3) + bt
        dx = conv(gt.permute(0, 2, 3, 4, 1), flip_weight(wt)).permute(0, 4, 1, 2, 3)
        return to_ndhwc(y), to_ndhwc(dx)
    wc = wt.permute(4, 3, 0, 1, 2)
    y = (tl.conv3d_z2d(xt, wc, (stride,) * 3) if per_tap
         else fn.conv3d(xt, wc, None, stride, 1)) + bt
    y.backward(gt)
    return to_ndhwc(y), to_ndhwc(xt.grad)


@pytest.mark.parametrize("stride,n", [(1, 32), (1, 16), (2, 64), (2, 32)],
                         ids=["s1-32-at", "s1-16-below", "s2-64-at", "s2-32-below"])
def test_conv_rounding_matches_jax(stride, n):
    """Forward, dx and dw bit-equal to JAX's ConvND on >= 95% of elements.
    At the threshold (32^3 output voxels) the forward is per tap, and dx too
    at stride 2, while stride 1's dx is once-rounded (jax.vjp of
    conv3d_zconcat); below it every conv rounds once. The share is then at
    least 10 points above the other rounding's, so each case tells the two
    apart."""
    x, w, b, g = conv_case(stride, n)
    at = ((n - 1) // stride + 1) ** 3 >= tl.MIN_VOLUME
    ref = jax_conv(x, w, b, g, stride)
    got = port_conv(x, w, b, g, stride)
    shares = [share(a, r) for a, r in zip(got, ref)]
    assert min(shares) >= 0.95, shares
    y_other, dx_other = other_rounding(x, w, b, g, stride, per_tap=not at)
    assert shares[0] >= share(y_other, ref[0]) + 0.1
    if stride == 1 and at:
        # the trap: kernel #2's own Function rounds dx per tap
        _, dx_other = other_rounding(x, w, b, g, stride, per_tap=True)
    if stride == 2 or at:
        assert shares[1] >= share(dx_other, ref[1]) + 0.1


def norm_case(masked, seed):
    rs = np.random.RandomState(seed)
    x = bf16((rs.rand(2, 8, 8, 16, C) - 0.3) * 3)
    keep = rs.rand(2, 2, 2, 4) > 0.4 if masked else None
    scale, bias = (1 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(
        np.float32)
    g = bf16(rs.randn(*x.shape))
    return x, keep, scale, bias, g


@pytest.mark.parametrize("masked", [False, True], ids=["InstanceNorm", "SparseInstanceNorm"])
def test_norm_rounding_matches_jax(masked):
    """bf16 InstanceNorm / SparseInstanceNorm (x*x squared in bf16) against
    JAX's. The forward is bit-equal on >= 99% of elements (an fp32 sum in
    another order can move an output one ulp). dx is not: JAX reduces the
    affine's cotangents (sum g*x and sum g over the voxels) in bf16, in an
    order of its backend's (XLA's CPU reduce is neither one rounding nor a
    running bf16 sum), and those per-channel sums reach every element of dx.
    dx is held within 2^-5 of max|dx|, one ulp at its largest elements
    (measured: 0.51 and 0.65 bit-equal, max|d| = 2^-5 at max|dx| = 4.6 and
    4.3); the moments' own backward is held bit for bit below. For the same
    reason the fp32 affine gradients are held within 5% of their largest
    (measured: 2.7%)."""
    x, keep, scale, bias, g = norm_case(masked, seed=7 + masked)
    params = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    xj = jnp.asarray(x, jnp.bfloat16)
    if masked:
        mod = jsp.SparseInstanceNorm(dtype=jnp.bfloat16)
        y, vjp = jax.vjp(lambda a, p: mod.apply(p, a, mask_nd(keep)), xj, params)
        norm = tsp.SparseInstanceNorm(C, dtype=torch.bfloat16)
    else:
        mod = jl.InstanceNorm(dtype=jnp.bfloat16)
        y, vjp = jax.vjp(lambda a, p: mod.apply(p, a), xj, params)
        norm = tl.InstanceNorm(C, dtype=torch.bfloat16)
    dx, dp = vjp(jnp.asarray(g, jnp.bfloat16))
    y, dx = (np.asarray(a.astype(jnp.float32)) for a in (y, dx))
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    xt = to_port(x, True)
    yt = norm(xt, mask_port(keep)) if masked else norm(xt)
    yt.backward(to_port(g))
    assert share(to_ndhwc(yt), y) >= 0.99
    assert np.abs(to_ndhwc(xt.grad) - dx).max() <= 2.0 ** -5 * np.abs(dx).max()
    for got, want in ((norm.weight.grad, dp["params"]["scale"]),
                      (norm.bias.grad, dp["params"]["bias"])):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 0.05 * np.abs(want).max()


def jax_moments(x, keep):
    """The statistics of JAX's bf16 norms as models/layers.py:218-219 (plain)
    and ssl/sparse.py `_masked_moments` (masked) write them: fp32 mean and
    var over the voxels of each sample, x*x squared in bf16."""
    if keep is None:
        mean = jnp.mean(x, (1, 2, 3), dtype=jnp.float32)
        var = jnp.maximum(jnp.mean(jnp.square(x), (1, 2, 3), dtype=jnp.float32)
                          - jnp.square(mean), 0.0)
        return mean, var
    m = jsp.mask_to_resolution(mask_nd(keep), x.shape[1:4])
    mean, var = jsp._masked_moments(x, m, (1, 2, 3))
    return mean[:, 0, 0, 0], var[:, 0, 0, 0]


def port_moments(x, keep):
    """The port's norms' statistics: InstanceNorm.forward's and
    ssl/sparse.py `_masked_moments`, (B, C) each."""
    if keep is None:
        s, ss = row_moments(x.permute(0, 2, 3, 4, 1), square_in_dtype=True)
        cnt = float(np.prod(x.shape[2:]))
        mean = s / cnt
        return mean, (ss / cnt - mean.square()).clamp_min(0.0)
    m = tsp.mask_to_resolution(mask_port(keep), x.shape[2:5])
    mean, var = tsp._masked_moments(x, m, False)
    return mean[:, :, 0, 0, 0], var[:, :, 0, 0, 0]


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_moments_with_the_flag_match_jax_vjp(masked):
    """The norms' fp32 mean and var, and their backward through row_moments
    with square_in_dtype: dx = (bf16(g_s) + bf16(bf16(g_ss) * 2x)) m, as
    jax.vjp computes it. mean and var to 1e-6 relative (fp32 sums in another
    order); dx bit-equal on >= 99.9% of elements (measured: 1.0), the rest
    one ulp apart where those sums moved a cotangent across a bf16 rounding
    boundary."""
    x, keep, _, _, _ = norm_case(masked, seed=9 + masked)
    rs = np.random.RandomState(10 + masked)
    g_mean, g_var = rs.randn(2, 2, C).astype(np.float32)
    (mean_j, var_j), vjp = jax.vjp(lambda a: jax_moments(a, keep), jnp.asarray(x, jnp.bfloat16))
    dx_j, = vjp((jnp.asarray(g_mean), jnp.asarray(g_var)))
    xt = to_port(x, True)
    mean_t, var_t = port_moments(xt, keep)
    for got, want in ((mean_t, mean_j), (var_t, var_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    torch.autograd.backward((mean_t, var_t), (torch.from_numpy(g_mean), torch.from_numpy(g_var)))
    assert share(to_ndhwc(xt.grad), np.asarray(dx_j.astype(jnp.float32))) >= 0.999
    # without the flag the sum of squares is another number at bf16
    s_f, ss_f = row_moments(xt.detach().permute(0, 2, 3, 4, 1))
    s_r, ss_r = row_moments(xt.detach().permute(0, 2, 3, 4, 1), square_in_dtype=True)
    assert torch.equal(s_f, s_r) and not torch.equal(ss_f, ss_r)


def test_tiny_spark_loss_matches_jax_at_bf16():
    """The tiny SparK (torch_parity's configuration at a 64^3 input, whose
    finest stages run the per-tap convs) in bf16: the forward loss within
    1e-3 of JAX's (measured: 4.0e-4). Not bit for bit: JAX folds its stages
    and rounds its transposed convs another way, and the loss is a mean of
    many bf16 outputs."""
    jcfg, tcfg = (replace(c, compute_dtype="bfloat16") for c in tiny_configs(patch=(64, 64, 64)))
    jmodel = jax_build_spark_model(jcfg)
    key = jax.random.PRNGKey(0)
    params = jax_random_params(jmodel, (1, 64, 64, 64, 1), 3, jmodel.mask(key, 1))
    tmodel = port_model(params, tcfg)
    rs = np.random.RandomState(17)
    x = rs.rand(1, 64, 64, 64, 1).astype(np.float32)
    keep = random_keep(rs, 1, jmodel.fmap, jmodel.len_keep)
    forward = jax.jit(lambda p, a, k: jmodel.apply({"params": p}, a, k))
    loss_j, _ = js.spark_loss(*forward(params, jnp.asarray(x), mask_nd(keep)), mask_nd(keep))
    with torch.no_grad():
        inp_t, rec_t = tmodel(to_ncdhw(x), mask_port(keep))
        loss_t, _ = ts.spark_loss(inp_t, rec_t, mask_port(keep))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-3)

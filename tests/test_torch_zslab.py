"""anatomask_torch.ops.zslab_conv on the CPU: the plain version and the
autograd Function against the JAX package's z-slab Pallas conv (interpret
mode), in fp32 and in bf16, where the per-tap rounding shows; and the wrapper's
checks. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.ops.pallas_zslab_conv import CH, conv3d_zslab as jax_zslab
from anatomask_torch.ops.conv3x3 import conv3d_3x3_plain
from anatomask_torch.ops.zslab_conv import (conv3d_zslab, conv3d_zslab_forward,
                                            conv3d_zslab_plain)

SHAPE, F = (2, 5, 2 * CH, 12, 6), 7  # tests/test_pallas_zslab.py's case


def _inputs(shape, F, seed, scale=0.1):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(3, 3, 3, shape[-1], F) * scale).astype(np.float32)
    return x, w


def _to_torch_bf16(a):
    """A bf16 JAX array as a bf16 tensor with the same values."""
    return torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16()


def _loss(y):
    return (y.float() ** 2).sum() * 1e-3


def test_fp32_forward_and_grads_match_jax_interpret():
    x, w = _inputs(SHAPE, F, seed=0)
    ref = np.asarray(jax_zslab(jnp.asarray(x), jnp.asarray(w), True))
    np.testing.assert_allclose(conv3d_zslab_plain(torch.from_numpy(x), torch.from_numpy(w)),
                               ref, rtol=1e-5, atol=1e-5)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = conv3d_zslab(xt, wt)
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    _loss(y).backward()
    gx, gw = jax.grad(lambda a, b: (jax_zslab(a, b, True) ** 2).sum() * 1e-3,
                      argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw), rtol=1e-4, atol=1e-5)


def test_bf16_per_tap_rounding_matches_jax_interpret():
    """In bf16 the plain version follows the TPU kernel's per-tap rounding:
    it agrees with JAX's interpret-mode result where a one-rounding bf16 conv
    (conv3d_3x3_plain) does not."""
    x, w = _inputs(SHAPE, F, seed=1, scale=0.3)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    ref = np.asarray(jax_zslab(xb, wb, True).astype(jnp.float32))
    xt = _to_torch_bf16(xb)
    wt = _to_torch_bf16(wb)
    got = conv3d_zslab_plain(xt, wt).float().numpy()
    once = conv3d_3x3_plain(xt, wt).float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale <= 1e-2
    # the per-tap result equals JAX's on nearly every element (an fp32 sum in
    # another order can round a tap one ulp apart); the one-rounding conv
    # departs from it on many
    same = np.mean(got == ref)
    assert same > 0.95
    assert np.mean(once == ref) < same - 0.1
    assert np.abs(once - got).max() > 0


def test_bf16_dx_matches_jax_interpret():
    x, w = _inputs(SHAPE, F, seed=2, scale=0.3)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    g = np.random.RandomState(3).randn(*SHAPE[:-1], F).astype(np.float32)
    gb = jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a: jax_zslab(a, wb, True), xb)
    ref = np.asarray(vjp(gb)[0].astype(jnp.float32))
    xt = _to_torch_bf16(xb).requires_grad_(True)
    wt = _to_torch_bf16(wb)
    conv3d_zslab(xt, wt).backward(_to_torch_bf16(gb))
    assert xt.grad.dtype == torch.bfloat16
    assert np.abs(xt.grad.float().numpy() - ref).max() / np.abs(ref).max() <= 1e-2


@pytest.mark.parametrize("shape,F", [((1, 4, 7, 9, 3), 5),    # H % 8 != 0
                                     ((2, 3, 5, 6, 1), 4),    # C = 1
                                     ((1, 6, 10, 5, 16), 8)])  # C != F, H % 8 != 0
def test_fp32_matches_one_rounding_conv_off_the_tpu_gate(shape, F):
    """In fp32 the per-tap rounding is exact, so shapes the TPU kernel's gate
    refuses agree with conv3d_3x3_plain."""
    x, w = _inputs(shape, F, seed=sum(shape) + F)
    got = conv3d_zslab_forward(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got, conv3d_3x3_plain(torch.from_numpy(x), torch.from_numpy(w)),
                               rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_makes_no_launch_and_checks_inputs():
    x, w = _inputs((1, 3, 4, 5, 2), 3, seed=4)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    conv3d_zslab.launches = 0
    conv3d_zslab(xt.requires_grad_(True), wt).sum().backward()
    assert conv3d_zslab.launches == 0
    with pytest.raises(ValueError):
        conv3d_zslab_forward(xt.detach().double(), wt.double())
    with pytest.raises(ValueError):
        conv3d_zslab_forward(xt.detach(), wt[:, :, :, :1])
    with pytest.raises(ValueError):
        conv3d_zslab_forward(xt.detach().transpose(2, 3), wt)

"""anatomask_torch.ops.conv3x3 on the CPU: the plain version against the JAX
package's Pallas conv (interpret mode) and lax conv, the autograd Function's
gradients against jax.grad through the Pallas VJP, and the wrapper's checks.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.ops.pallas_conv import _lax_conv, conv3d_3x3 as jax_conv3d_3x3
from anatomask_tpu.ops.pallas_conv import pallas_conv3d_available
from anatomask_torch.ops import _build
from anatomask_torch.ops import conv3x3 as conv_mod
from anatomask_torch.ops.conv3x3 import (conv3d_3x3, conv3d_3x3_forward, conv3d_3x3_plain,
                                         flip_weight)
from anatomask_torch.ssl.pretrain import PretrainConfig, build_spark_model

# (x shape NDHWC, F): the cases of tests/test_pallas_conv.py, C = 1 (the stem
# conv), the 7x7x8 bottom level and shapes the TPU kernel's gate refuses
CASES = [
    ((2, 4, 16, 16, 4), 6),
    ((1, 6, 32, 16, 2), 3),
    ((1, 4, 16, 16, 64), 8),
    ((1, 4, 16, 16, 3), 4),
    ((2, 8, 8, 16, 1), 5),
    ((1, 7, 7, 8, 16), 12),
    ((1, 7, 9, 16, 2), 2),
    ((1, 5, 6, 7, 40), 3),
]


def _inputs(shape, F, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(*shape).astype(np.float32)
    w = (rs.rand(3, 3, 3, shape[-1], F) - 0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape,F", CASES)
def test_plain_matches_jax(shape, F):
    x, w = _inputs(shape, F, seed=sum(shape) + F)
    got = conv3d_3x3_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(_lax_conv(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-4)
    if pallas_conv3d_available(shape):
        ref = jax_conv3d_3x3(jnp.asarray(x), jnp.asarray(w), use_pallas=True, interpret=True)
        np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("shape,F", [((1, 4, 16, 16, 3), 4), ((2, 8, 8, 16, 1), 5),
                                     ((1, 7, 7, 8, 16), 12), ((1, 4, 16, 16, 64), 8)])
def test_gradients_match_jax_pallas_vjp(shape, F):
    x, w = _inputs(shape, F, seed=7 * F)
    t = np.random.RandomState(F).rand(*shape[:-1], F).astype(np.float32)

    def loss(x, w):
        y = jax_conv3d_3x3(x, w, use_pallas=pallas_conv3d_available(shape), interpret=True)
        return jnp.sum((y - t) ** 2)

    gx_j, gw_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    ((conv3d_3x3(xt, wt) - torch.from_numpy(t)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=1e-3, rtol=1e-4)


def test_dx_is_the_conv_with_the_flipped_weight():
    x, w = _inputs((1, 5, 6, 8, 4), 3, seed=1)
    g = np.random.RandomState(2).rand(1, 5, 6, 8, 3).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    conv3d_3x3(xt, torch.from_numpy(w)).backward(torch.from_numpy(g))
    dx = conv3d_3x3_plain(torch.from_numpy(g), flip_weight(torch.from_numpy(w)))
    np.testing.assert_allclose(xt.grad.numpy(), dx.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("x_needs_grad,passes", [(False, 1), (True, 2)])
def test_dx_pass_runs_only_where_the_input_needs_it(monkeypatch, x_needs_grad, passes):
    """The stem conv reads the masked input, which carries no gradient: its
    backward runs no dx pass (a step launches 50 kernels, not 51)."""
    calls = []
    forward = conv_mod.conv3d_3x3_forward
    monkeypatch.setattr(conv_mod, "conv3d_3x3_forward",
                        lambda x, w: calls.append(x.shape) or forward(x, w))
    x, w = _inputs((1, 4, 4, 4, 1), 2, seed=3)
    xt = torch.from_numpy(x).requires_grad_(x_needs_grad)
    wt = torch.from_numpy(w).requires_grad_(True)
    conv3d_3x3(xt, wt).sum().backward()
    assert len(calls) == passes
    assert wt.grad is not None and wt.grad.shape == (3, 3, 3, 1, 2)


def test_plain_path_counts_no_launch():
    x, w = _inputs((1, 4, 4, 4, 2), 2, seed=4)
    before = conv3d_3x3.launches
    conv3d_3x3(torch.from_numpy(x), torch.from_numpy(w))
    assert conv3d_3x3.launches == before


def test_plain_keeps_bf16_rounding_once():
    x, w = _inputs((1, 4, 6, 8, 8), 8, seed=5)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = conv3d_3x3_plain(xb, wb)
    ref = conv3d_3x3_plain(xb.float(), wb.float()).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)


@pytest.mark.parametrize("bad", ["meta_device", "mixed_dtype", "not_3x3", "non_contiguous",
                                 "float16"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.rand(1, 4, 4, 4, 2)
    w = torch.rand(3, 3, 3, 2, 3)
    if bad == "meta_device":
        x, w = x.to("meta"), w.to("meta")
    elif bad == "mixed_dtype":
        w = w.bfloat16()
    elif bad == "not_3x3":
        w = torch.rand(1, 1, 1, 2, 3)
    elif bad == "non_contiguous":
        x = torch.rand(1, 4, 4, 2, 4).transpose(3, 4)
    else:
        x, w = x.half(), w.half()
    with pytest.raises(ValueError):
        conv3d_3x3_forward(x, w)


def test_entry_point_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PretrainConfig(patch_size=(32, 32, 32), encoder_dims=(4, 8, 16, 32, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_spark_model(cfg)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_build_path_tracks_the_source():
    path = _build.library_path("conv3x3")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("conv3x3-") and path.suffix == ".so"
    assert (_build.CSRC / "conv3x3.cu").is_file()

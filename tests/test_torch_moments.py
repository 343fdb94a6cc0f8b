"""anatomask_torch.ops.moments on the CPU: the plain version of the per-row
moments against the JAX package's `folded_row_sums` (masked and unmasked) and
against the TPU kernel `pallas_moments` in interpret mode, the autograd
Function's backward against jax.grad, the norms built on it, and the
wrapper's checks. The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py."""
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.ops.moments import folded_row_sums
from anatomask_tpu.ssl import sparse as jsp
from anatomask_torch.ops import _build
from anatomask_torch.ops.moments import (row_moments, row_moments_forward,
                                         row_moments_plain)
from anatomask_torch.ssl import sparse as tsp

from torch_parity import mask_nd, mask_port, to_ncdhw

ROOT = Path(__file__).resolve().parents[1]
# fp32 sums of a few hundred terms, taken in another order than JAX's
RTOL, ATOL = 1e-5, 1e-5


def _inputs(C, masked, seed, batch=2):
    rs = np.random.RandomState(seed)
    x = ((rs.rand(batch, 8, 5, 7, C) - 0.3) * 3).astype(np.float32)
    keep = rs.rand(batch, 8, 5, 7) > 0.4 if masked else None
    return x, keep


def _jax_sums(x, keep):
    """folded_row_sums on the (B*X, Y, Z, C) fold, rows summed per sample."""
    B, X, Y, Z, C = x.shape
    mx = None if keep is None else jnp.asarray(keep.reshape(B * X, Y, Z, 1), jnp.float32)
    s, ss = folded_row_sums(x.reshape(B * X, Y, Z, C), mx)
    return s.reshape(B, X, C).sum(1), ss.reshape(B, X, C).sum(1)


def _port_mask(keep):
    return None if keep is None else torch.from_numpy(keep)


@pytest.mark.parametrize("C", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_folded_row_sums(C, masked):
    x, keep = _inputs(C, masked, seed=C + masked)
    ref = _jax_sums(jnp.asarray(x), keep)
    got = row_moments(torch.from_numpy(x), _port_mask(keep))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (2, C)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def pallas_moments():
    """The TPU kernel in interpret mode. The probe reads PROBE_INTERPRET and
    sets JAX's compilation cache when it is imported: both are restored."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    mp = pytest.MonkeyPatch()
    mp.setenv("PROBE_INTERPRET", "1")
    try:
        spec = importlib.util.spec_from_file_location(
            "probe_rowstats_interpret", ROOT / "probes" / "probe_rowstats.py")
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
    finally:
        mp.undo()
        for k, v in saved.items():
            jax.config.update(k, v)
    assert probe.INTERPRET
    return probe.pallas_moments


@pytest.mark.parametrize("C", [4, 8])
def test_plain_matches_pallas_moments_interpret(pallas_moments, C):
    """pallas_moments gives per-row means of an (N, H, W, C) tensor, N a
    multiple of its 8-row block: fold (B, X, Y, Z, C) to (B*X, Y, Z, C)."""
    x, _ = _inputs(C, False, seed=20 + C)
    B, X, Y, Z, _ = x.shape
    row_m, row_m2 = pallas_moments(jnp.asarray(x.reshape(B * X, Y, Z, C)))
    s, ss = row_moments(torch.from_numpy(x))
    for got, mean in ((s, row_m), (ss, row_m2)):
        ref = (np.asarray(mean, np.float64) * (Y * Z)).reshape(B, X, C).sum(1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_grad(masked):
    x, keep = _inputs(4, masked, seed=30 + masked)
    a, b = np.random.RandomState(31).randn(2, 2, 4).astype(np.float32)

    def loss(xj):
        s, ss = _jax_sums(xj, keep)
        return jnp.sum(a * s + b * ss)

    ref = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    s, ss = row_moments(xt, _port_mask(keep))
    (torch.from_numpy(a) * s + torch.from_numpy(b) * ss).sum().backward()
    # elementwise a + 2 b x: only the rounding of each product differs
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_bf16_is_squared_in_fp32():
    """With square_in_dtype unset the plain version widens bf16 to fp32
    before squaring, as the kernel and the TPU kernel do: the same sums as on
    the widened input."""
    x, keep = _inputs(8, True, seed=40)
    xb = torch.from_numpy(x).bfloat16()
    got = row_moments_plain(xb, _port_mask(keep), square_in_dtype=False)
    ref = row_moments_plain(xb.float(), _port_mask(keep))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("masked", [False, True])
def test_bf16_squared_in_bf16_matches_folded_row_sums(masked):
    """With square_in_dtype the plain version rounds x*x to bf16 before the
    fp32 sum, as the JAX package's `folded_row_sums` does at bf16; fp32 sums
    in another order. In fp32 the flag changes nothing."""
    x, keep = _inputs(8, masked, seed=43 + masked)
    xb = jnp.asarray(x, jnp.bfloat16)
    B, X, Y, Z, C = x.shape
    mx = None if keep is None else jnp.asarray(keep.reshape(B * X, Y, Z, 1), jnp.bfloat16)
    s, ss = folded_row_sums(xb.reshape(B * X, Y, Z, C), mx)
    ref = s.reshape(B, X, C).sum(1), ss.reshape(B, X, C).sum(1)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    got = row_moments(xt, _port_mask(keep), square_in_dtype=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    assert not torch.equal(got[1], row_moments(xt, _port_mask(keep))[1])
    for a, b in zip(row_moments(xt.float(), _port_mask(keep), square_in_dtype=True),
                    row_moments(xt.float(), _port_mask(keep))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("batch_pooled", [False, True])
def test_sparse_norm_with_an_empty_sample_matches_jax(batch_pooled):
    """A sample with no visible voxel: its count is clamped to 1, its
    statistics are 0, and its output is all zeros, as in JAX."""
    rs = np.random.RandomState(41)
    x = (rs.rand(2, 4, 4, 6, 8) * 5).astype(np.float32)
    keep = rs.rand(2, 2, 2, 3) > 0.4
    keep[1] = False
    scale, bias = rs.randn(2, 8).astype(np.float32)
    mod = jsp.SparseInstanceNorm(epsilon=1e-6, batch_pooled=batch_pooled)
    ref = mod.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x), mask_nd(keep))
    norm = tsp.SparseInstanceNorm(8, eps=1e-6, batch_pooled=batch_pooled)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(to_ncdhw(x), mask_port(keep)).permute(0, 2, 3, 4, 1).numpy()
    assert not got[1].any()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_plain_path_counts_no_launch():
    x, keep = _inputs(4, True, seed=42)
    before = row_moments.launches
    row_moments(torch.from_numpy(x), _port_mask(keep))
    assert row_moments.launches == before


@pytest.mark.parametrize("bad", ["meta_device", "float16", "non_contiguous", "mask_shape",
                                 "mask_dtype", "not_5d"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.rand(2, 3, 4, 5, 8)
    mask = torch.rand(2, 3, 4, 5) > 0.5
    if bad == "meta_device":
        x, mask = x.to("meta"), mask.to("meta")
    elif bad == "float16":
        x = x.half()
    elif bad == "non_contiguous":
        x = torch.rand(2, 3, 4, 8, 5).transpose(3, 4)
    elif bad == "mask_shape":
        mask = mask[:, :, :, :4]
    elif bad == "mask_dtype":
        mask = mask.float()
    else:
        x = x[0]
    with pytest.raises(ValueError):
        row_moments_forward(x, mask)


def test_build_path_tracks_the_source():
    path = _build.library_path("moments")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("moments-") and path.suffix == ".so"
    assert path != _build.library_path("conv3x3")

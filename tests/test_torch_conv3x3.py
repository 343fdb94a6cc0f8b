"""anatomask_torch.ops.conv3x3 on the CPU: the plain version against the JAX
package's Pallas conv (interpret mode) and lax conv, the autograd Function's
gradients against jax.grad through the Pallas VJP, and the wrapper's checks.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.ops.pallas_conv import _lax_conv, conv3d_3x3 as jax_conv3d_3x3
from anatomask_tpu.ops.pallas_conv import pallas_conv3d_available
from anatomask_torch.ops import _build
from anatomask_torch.ops import conv3x3 as conv_mod
from anatomask_torch.ops.conv3x3 import (HOPPER_TILES, conv3d_3x3, conv3d_3x3_forward,
                                         conv3d_3x3_plain, flip_weight, igemm_tile,
                                         igemm_variant, pack_weight)
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
                        lambda x, w, padding=1: calls.append(x.shape) or forward(x, w, padding))
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


@pytest.mark.parametrize("dtype,C,F", [(torch.bfloat16, 32, 32), (torch.float32, 32, 32),
                                       (torch.bfloat16, 1, 32), (torch.bfloat16, 64, 12)])
def test_plain_path_counts_no_launch_by_variant(dtype, C, F):
    """A CPU tensor takes the plain version whatever variant its shape would
    pick on the card: neither per-variant count moves, forward or dx."""
    x = torch.rand(1, 3, 4, 5, C, dtype=dtype).requires_grad_(True)
    w = torch.rand(3, 3, 3, C, F, dtype=dtype)
    before = dict(conv3d_3x3.launches_by_variant)
    conv3d_3x3(x, w).float().sum().backward()
    assert conv3d_3x3.launches_by_variant == before


def _unaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize("case,variant", [
    ("bf16 C=F=32", "hopper"), ("bf16 C=1024 F=512", "hopper"), ("bf16 C=96 F=160", "hopper"),
    ("fp32 C=F=64", "tf32x3"), ("bf16 C=1 (stem)", "stem"), ("bf16 F=12", "simple"),
    ("bf16 C=48", "simple"), ("bf16 unaligned x", "simple")])
def test_igemm_variant(case, variant):
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    C, F = {"bf16 C=F=32": (32, 32), "bf16 C=1024 F=512": (1024, 512),
            "bf16 C=96 F=160": (96, 160), "fp32 C=F=64": (64, 64), "bf16 C=1 (stem)": (1, 32),
            "bf16 F=12": (64, 12), "bf16 C=48": (48, 64), "bf16 unaligned x": (64, 64)}[case]
    shape = (1, 3, 4, 5, C)
    x = _unaligned(shape, dtype) if "unaligned" in case else torch.zeros(shape, dtype=dtype)
    assert (x.data_ptr() % 16 != 0) == ("unaligned" in case)
    assert igemm_variant(x, torch.zeros(3, 3, 3, C, F, dtype=dtype)) == variant


def test_igemm_tile_is_one_the_launcher_builds():
    """Every (BK, BN) that igemm_tile picks for C, F multiples of 32 is among
    the tiles the C launcher instantiates (CONV3X3_HOPPER_TILES), and is the
    largest that divides: BK of (64, 32) dividing C, BN of (128, 64, 32)
    dividing F."""
    header = (_build.CSRC / "conv3x3_igemm.cuh").read_text()
    body = header[header.index("#define CONV3X3_HOPPER_TILES"):].split("\n\n")[0]
    built = {(int(a), int(b)) for a, b in re.findall(r"TILE\((\d+), (\d+)\)", body)}
    assert built == set(HOPPER_TILES)
    picked = set()
    for C in range(32, 1025, 32):
        for F in range(32, 1025, 32):
            bk, bn = igemm_tile(C, F)
            assert (bk, bn) in built and C % bk == 0 and F % bn == 0
            assert bk == max(b for b in (64, 32) if C % b == 0)
            assert bn == max(b for b in (128, 64, 32) if F % b == 0)
            picked.add((bk, bn))
    assert picked == built
    assert [igemm_tile(C, F) for C, F in [(32, 32), (64, 32), (32, 64), (96, 160), (512, 512),
                                          (1024, 512)]] == [
        (32, 32), (64, 32), (32, 64), (32, 32), (64, 128), (64, 128)]


@pytest.mark.parametrize("C,F", [(32, 64), (96, 32), (8, 12)])
def test_pack_weight_k_major(C, F):
    """The hopper variant's weight is (F, 27*C) with K = (tap, c) contiguous:
    w.reshape(27*C, F).t() for the forward, flip_weight(w).reshape(27*F, C).t()
    for dx; the simple variant keeps (27*C, F)."""
    w = torch.from_numpy(np.random.RandomState(C + F).rand(3, 3, 3, C, F).astype(np.float32))
    w = w.bfloat16()
    fwd = pack_weight(w, "hopper")
    assert fwd.shape == (F, 27 * C) and fwd.is_contiguous()
    assert torch.equal(fwd, w.reshape(27 * C, F).t())
    dx = pack_weight(flip_weight(w), "hopper")
    assert dx.shape == (C, 27 * F) and dx.is_contiguous()
    assert torch.equal(dx, flip_weight(w).reshape(27 * F, C).t())
    # element for element: row f, column tap * C + c holds w[dx, dy, dz, c, f]
    tap, c, f = 14, C - 1, F - 1
    assert fwd[f, tap * C + c] == w[tap // 9, tap // 3 % 3, tap % 3, c, f]
    assert dx[c, tap * F + f] == w[2 - tap // 9, 2 - tap // 3 % 3, 2 - tap % 3, c, f]
    assert torch.equal(pack_weight(w, "simple"), w.reshape(27 * C, F))


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

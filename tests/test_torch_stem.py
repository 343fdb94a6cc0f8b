"""The stem variant of the shared 3x3x3 conv (csrc/conv3x3_stem.cuh) on the
CPU: its plain versions at the stem shapes (C = 1, 3, 4; F = 16, 32) against
the JAX package in bf16 and fp32, at padding 1 (the z-slab Pallas conv in
interpret mode) and 0 (the block-sparse route's block_conv3); the variant
rule that sends a conv to it; its weight layout; and that its C launchers
instantiate every channel count the rule sends. The CUDA kernel itself is
held against the plain versions on the card by chip_smoke.py."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomask_tpu.ops import block_sparse as jbs
from anatomask_tpu.ops.pallas_zslab_conv import CH, conv3d_zslab as jax_zslab
from anatomask_torch.ops import _build
from anatomask_torch.ops.conv3x3 import (STEM_MAX_C, STEM_MAX_F, VARIANTS, conv3d_3x3_plain,
                                         conv_variant, igemm_variant, pack_weight, stem_rows)
from anatomask_torch.ops.zslab_conv import conv3d_zslab_plain

STEM_SHAPES = [(C, F) for C in (1, 3, 4) for F in (16, 32)]


def _inputs(shape, F, seed, scale):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(3, 3, 3, shape[-1], F) * scale / np.sqrt(shape[-1])).astype(np.float32)
    return x, w


def _bf16(a):
    """A float32 array rounded to bf16, as a bf16 JAX array and a bf16 tensor."""
    ja = jnp.asarray(a, jnp.bfloat16)
    return ja, torch.tensor(np.asarray(ja.astype(jnp.float32))).bfloat16()


def _per_tap_gates(got, once, ref):
    """The bf16 gates of kernel #2: rel. max error <= 1e-2, bit-equal to the
    reference on >= 95% of the elements, and the once-rounded conv at least
    10 points lower."""
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-2
    same = np.mean(got == ref)
    assert same >= 0.95
    assert np.mean(once == ref) <= same - 0.1


_jit_block_conv3 = jax.jit(jbs.block_conv3)
_jit_zslab = jax.jit(lambda x, w: jax_zslab(x, w, True))
F_MAX = max(F for _, F in STEM_SHAPES)


@functools.lru_cache(maxsize=None)
def _zslab_case(C):
    """Inputs at C channels and F_MAX outputs, with the interpret-mode z-slab
    conv of them in bf16 and fp32; a narrower F takes the first F output
    channels (each depends on its own weights alone)."""
    x, w = _inputs((1, 2, CH, 5, C), F_MAX, seed=10 * C, scale=0.5)
    xb, _ = _bf16(x)
    wb, _ = _bf16(w)
    return (x, w, np.asarray(_jit_zslab(xb, wb).astype(jnp.float32)),
            np.asarray(_jit_zslab(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("C,F", STEM_SHAPES)
def test_per_tap_plain_matches_jax_zslab_interpret(C, F):
    """Padding 1: the per-tap plain version (kernel #2's) against the z-slab
    Pallas conv in interpret mode, bf16 and fp32 (where the per-tap rounding
    is exact, so the once-rounded plain version agrees too)."""
    x, w, ref, ref32 = _zslab_case(C)
    w, ref, ref32 = w[..., :F], ref[..., :F], ref32[..., :F]
    _, xt = _bf16(x)
    _, wt = _bf16(w)
    _per_tap_gates(conv3d_zslab_plain(xt, wt).float().numpy(),
                   conv3d_3x3_plain(xt, wt).float().numpy(), ref)
    x32, w32 = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w))
    np.testing.assert_allclose(conv3d_zslab_plain(x32, w32).numpy(), ref32, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(conv3d_3x3_plain(x32, w32).numpy(), ref32, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _block_case(C):
    """Halo'd blocks (B, K, e, e, e, C) and F_MAX weights, with JAX's
    block_conv3 of them in bf16 and fp32 (a narrower F as in _zslab_case)."""
    x, w = _inputs((1, 3, 6, 6, 6, C), F_MAX, seed=100 + 10 * C, scale=0.5)
    xb, _ = _bf16(x)
    wb, _ = _bf16(w)
    return (x, w, np.asarray(_jit_block_conv3(xb, wb).astype(jnp.float32)),
            np.asarray(_jit_block_conv3(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("C,F", STEM_SHAPES)
def test_per_tap_plain_matches_jax_block_conv3(C, F):
    """Padding 0 (the block-sparse route's VALID conv of halo'd blocks):
    conv3d_zslab_plain at padding 0 against JAX's block_conv3, bf16 and
    fp32."""
    x, w, ref, ref32 = _block_case(C)
    w, ref, ref32 = np.ascontiguousarray(w[..., :F]), ref[..., :F], ref32[..., :F]
    B, K, e = x.shape[:3]
    _, xt = _bf16(x)
    _, wt = _bf16(w)
    flat = xt.reshape(B * K, e, e, e, C)
    _per_tap_gates(conv3d_zslab_plain(flat, wt, 0).float().reshape(ref.shape).numpy(),
                   conv3d_3x3_plain(flat, wt, 0).float().reshape(ref.shape).numpy(), ref)
    got32 = conv3d_zslab_plain(torch.from_numpy(x).reshape(B * K, e, e, e, C),
                               torch.from_numpy(w), 0)
    np.testing.assert_allclose(got32.reshape(ref32.shape).numpy(), ref32, rtol=1e-5, atol=1e-5)


# the fp32 stems' grid beyond the two path stems (1 -> 32, 4 -> 32, aligned)
FP32_STEM_GRID = [(C, F, a) for C in (1, 2, 3, 4, 5, STEM_MAX_C) for F in (16, 32, 48, 96)
                  for a in (True, False) if (C, F, a) not in ((1, 32, True), (4, 32, True))]
# (dtype, C, F, 16-byte-aligned x) -> variant: every stem of the paths in
# both dtypes, the stem domain's edges, and the shapes around it
RULE_CASES = (
    [((torch.bfloat16, C, F, True), "stem") for C, F in ((1, 32), (3, 32), (4, 32), (1, 96))]
    + [((torch.bfloat16, C, F, a), "stem") for C in (2, 5, STEM_MAX_C) for F in (16, 48)
       for a in (True, False)]
    + [((torch.bfloat16, C, F, True), "simple") for C, F in ((STEM_MAX_C + 1, 32), (1, 8),
                                                              (1, 24), (4, STEM_MAX_F + 16),
                                                              (1, 128), (32, 1), (32, 16))]
    + [((torch.float32, C, F, True), "stem") for C, F in ((1, 32), (4, 32))]
    + [((torch.float32, C, F, a), "stem") for C, F, a in FP32_STEM_GRID]
    + [((torch.float32, C, F, True), "simple") for C, F in ((STEM_MAX_C + 1, 32), (1, 8),
                                                             (1, STEM_MAX_F + 16))]
    + [((torch.float32, 32, 32, True), "tf32x3")]
    + [((torch.bfloat16, 32, 32, True), "hopper"), ((torch.bfloat16, 32, 32, False), "simple"),
       ((torch.bfloat16, 64, 96, True), "hopper")])


@pytest.mark.parametrize("case,variant", RULE_CASES,
                         ids=[f"{str(c[0])[6:]}-C{c[1]}-F{c[2]}-{'al' if c[3] else 'unal'}"
                              for c, _ in RULE_CASES])
def test_conv_variant_rule(case, variant):
    """conv_variant is the one rule: igemm_variant gives the same answer for
    tensors of that dtype, shape and alignment."""
    dtype, C, F, aligned = case
    assert conv_variant(dtype, C, F, aligned) == variant
    n = 3 * 4 * 5 * C
    x = torch.zeros(n + 8, dtype=dtype)[(0 if aligned else 1):][:n].view(1, 3, 4, 5, C)
    assert (x.data_ptr() % 16 == 0) == aligned
    assert igemm_variant(x, torch.zeros(3, 3, 3, C, F, dtype=dtype)) == variant
    assert variant in VARIANTS


@pytest.mark.parametrize("C", range(1, STEM_MAX_C + 1))
def test_pack_weight_stem_unpacks(C):
    """pack_weight(w, "stem") is (F, 3 * KT), K contiguous: column dx * KT +
    dy * R + dz * C + c holds w[dx, dy, dz, c, f], every other column is
    exactly zero; KT is a multiple of 16 covering 3 * R, R = 3C rounded up
    to even."""
    F = 48
    w = torch.from_numpy(np.random.RandomState(C).randn(3, 3, 3, C, F).astype(np.float32))
    w = w.bfloat16()
    R, KT = stem_rows(C)
    assert R == 3 * C + C % 2 and KT % 16 == 0 and 3 * R <= KT < 3 * R + 16
    p = pack_weight(w, "stem")
    assert p.shape == (F, 3 * KT) and p.is_contiguous() and p.dtype == w.dtype
    taps = p.view(F, 3, KT)
    rows = taps[:, :, :3 * R].reshape(F, 3, 3, R)
    assert torch.equal(rows[..., :3 * C].reshape(F, 3, 3, 3, C).permute(1, 2, 3, 4, 0), w)
    assert not rows[..., 3 * C:].any() and not taps[:, :, 3 * R:].any()


def test_stem_launchers_instantiate_every_channel_count():
    """The stem header instantiates exactly the channel counts 1..STEM_MAX_C
    that conv_variant sends to it, in bf16 and in fp32 (the launcher picks
    the kernel by the dtype code), its F limit is STEM_MAX_F, its K layout
    is stem_rows' (the fp32 kernel reads the same packed weight), and both
    conv sources expose a _stem launcher that passes the dtype on, with
    their rounding (kernel #1 once, kernel #2 per tap)."""
    header = (_build.CSRC / "conv3x3_stem.cuh").read_text()
    body = header[header.index("#define CONV3X3_STEM_CHANNELS"):].split("\n")[0]
    assert [int(c) for c in re.findall(r"C_\((\d+)\)", body)] == list(range(1, STEM_MAX_C + 1))
    assert re.search(rf"constexpr int MAX_C = {STEM_MAX_C};", header)
    assert re.search(rf"constexpr int MAX_F = {STEM_MAX_F};", header)
    assert "R = 3 * C + (ODD ? 1 : 0)" in header and "KC = (KREAL + 15) / 16" in header
    assert "CONV3X3_STEM_CHANNELS(CONV3X3_STEM_CASE)" in header
    case = header[header.rindex("#define CONV3X3_STEM_CASE"):].split("CONV3X3_STEM_CHANNELS")[0]
    assert re.search(r"dtype == 1 \? launch_c<C_, PER_TAP>\(.*\)\s*:\s*f32::launch_c<C_, PER_TAP>",
                     case.replace("\\\n", " "), re.S)
    assert "stem_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w" in header
    assert "R = 3 * C + C % 2, KT = (3 * R + 15) / 16 * 16" in header
    for source, symbol, per_tap in (("conv3x3.cu", "conv3x3_forward_stem", "false"),
                                    ("zslab_conv.cu", "zslab_forward_stem", "true")):
        text = (_build.CSRC / source).read_text()
        assert '#include "conv3x3_stem.cuh"' in text
        entry = text[text.index(f'extern "C" int {symbol}('):].split("}")[0]
        assert "int p, int dtype, void* stream)" in entry
        assert (f"conv3x3_stem::launch<{per_tap}>(x, w, y, B, X, Y, Z, C, F, p, dtype, stream)"
                in entry)
    # every (C, F) the rule sends to the stem lies in the launcher's domain
    for dtype in (torch.bfloat16, torch.float32):
        for C in range(1, 40):
            for F in range(1, 200):
                if conv_variant(dtype, C, F) == "stem":
                    assert 1 <= C <= STEM_MAX_C and F % 16 == 0 and 16 <= F <= STEM_MAX_F

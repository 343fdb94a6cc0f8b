"""The fp32 stem (csrc/conv3x3_stem.cuh's fp32 kernel, the stem variant at
float32) on the CPU: its plain versions, both roundings, against the JAX
package in fp32 at C = 1, 3, 4 and F = 32, 96 at padding 1 (the z-slab
Pallas conv in interpret mode), 0 (the block-sparse route's block_conv3) and
2 (its dx, through jax.vjp); the fp32 weight layout; chip_smoke.py's
tables for it: its fp32 stem shapes take the stem variant; and the
benchmark's trace (benchmark/trace.py) files the port's stem kernels and
cuDNN's weight-gradient kernels in their groups. The CUDA kernel itself is
held against the plain versions on the card by chip_smoke.py's fp32 gates."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anatomask_tpu.ops import block_sparse as jbs
from anatomask_tpu.ops.pallas_zslab_conv import CH, conv3d_zslab as jax_zslab
from anatomask_torch.ops.conv3x3 import (STEM_MAX_C, conv3d_3x3_plain, conv_variant,
                                         pack_weight, stem_rows)
from anatomask_torch.ops.zslab_conv import conv3d_zslab_plain

F_MAX = 96
CASES = [(C, F, p) for C in (1, 3, 4) for F in (32, F_MAX) for p in (0, 1, 2)]
_jit_zslab = jax.jit(lambda x, w: jax_zslab(x, w, True))
_jit_block_conv3 = jax.jit(jbs.block_conv3)


@jax.jit
def _block_dx(x, w, g):
    """The block conv's dx: the full (padding 2) conv of g by the flipped weight."""
    return jax.vjp(lambda b: jbs.block_conv3(b, w), x)[1](g)[0]


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _case(C, padding):
    """(x, w, the JAX package's fp32 conv of x by w) for the stem C -> F_MAX
    at `padding`: 1, the z-slab conv in interpret mode; 0, block_conv3 on
    halo'd blocks; 2, block_conv3's dx (jax.vjp) of an output gradient x of
    C channels, through a block conv of F_MAX -> C channels whose weight
    flipped (ops/conv3x3.py flip_weight) is w. A narrower F takes the first F output
    channels, each of which depends on its own weights alone."""
    w = _randn(10 * C + padding, 3, 3, 3, C, F_MAX, scale=0.5 / np.sqrt(C))
    if padding == 1:
        x = _randn(C, 1, 2, CH, 5, C)
        return x, w, np.asarray(_jit_zslab(jnp.asarray(x), jnp.asarray(w)))
    if padding == 0:
        x = _randn(100 + C, 1, 3, 6, 6, 6, C)
        ref = np.asarray(_jit_block_conv3(jnp.asarray(x), jnp.asarray(w)))
        return x.reshape(3, 6, 6, 6, C), w, ref.reshape(3, 4, 4, 4, F_MAX)
    g = _randn(200 + C, 1, 3, 4, 4, 4, C)
    w_block = np.ascontiguousarray(np.flip(w, (0, 1, 2)).transpose(0, 1, 2, 4, 3))
    ref = np.asarray(_block_dx(jnp.zeros((1, 3, 6, 6, 6, F_MAX)), jnp.asarray(w_block),
                               jnp.asarray(g)))
    return g.reshape(3, 4, 4, 4, C), w, ref.reshape(3, 6, 6, 6, F_MAX)


@pytest.mark.parametrize("C,F,padding", CASES)
def test_fp32_stem_plain_matches_jax(C, F, padding):
    """Both plain versions of the fp32 stem (kernel #2's, each tap summed in
    fp32 and the three added in fp32; kernel #1's, one fp32 sum) against the
    JAX package's fp32 conv of the same inputs, within 1e-5."""
    x, w, ref = _case(C, padding)
    xt, wt = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w[..., :F]))
    assert conv_variant(torch.float32, C, F) == "stem"
    for plain in (conv3d_zslab_plain, conv3d_3x3_plain):
        np.testing.assert_allclose(plain(xt, wt, padding).numpy(), ref[..., :F],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", range(1, STEM_MAX_C + 1))
def test_pack_weight_stem_unpacks_fp32(C):
    """pack_weight(w, "stem") of an fp32 weight is the bf16 layout in fp32:
    (F, 3 * KT), column dx * KT + dy * R + dz * C + c holds w[dx, dy, dz, c,
    f] bit for bit, every other column is exactly zero."""
    F = 32
    w = torch.from_numpy(_randn(300 + C, 3, 3, 3, C, F))
    R, KT = stem_rows(C)
    p = pack_weight(w, "stem")
    assert p.shape == (F, 3 * KT) and p.is_contiguous() and p.dtype == torch.float32
    taps = p.view(F, 3, KT)
    rows = taps[:, :, :3 * R].reshape(F, 3, 3, R)
    assert torch.equal(rows[..., :3 * C].reshape(F, 3, 3, 3, C).permute(1, 2, 3, 4, 0), w)
    assert not rows[..., 3 * C:].any() and not taps[:, :, 3 * R:].any()


def test_chip_smoke_fp32_stem_shapes():
    """chip_smoke.py's fp32 stems, the paths' (fp32_launches) and the gated
    FP32_STEM_SHAPES, take the stem variant on kernel #2 (>= MIN_VOLUME
    voxels a sample), and the float32 paths' expected launches run no
    simple variant."""
    import chip_smoke as cs
    stems = [(C, F, vol) for path in cs.FP32_PATHS
             for _, C, F, vol in cs.fp32_launches(path) if C <= STEM_MAX_C]
    stems += [(C, F, vol) for _, _, C, F, vol in cs.FP32_STEM_SHAPES]
    assert len(stems) == 5
    for C, F, vol in stems:
        assert conv_variant(torch.float32, C, F) == "stem" and cs.per_tap(vol)
    for want in (cs.FP32_STEP_LAUNCHES, cs.FP32_VAL_LAUNCHES, cs.FP32_TILE_LAUNCHES):
        assert want["conv3x3.simple"] == want["zslab.simple"] == 0 and want["zslab.stem"] > 0


@pytest.mark.parametrize("name,group", [
    ("void conv3x3_stem::stem_kernel<1, true>(unsigned short const*, uint4 const*, "
     "__nv_bfloat16*, conv3x3_stem::Shape)", "conv"),
    ("void conv3x3_stem::stem_kernel<4, false>(unsigned short const*, uint4 const*, "
     "__nv_bfloat16*, conv3x3_stem::Shape)", "conv"),
    ("void conv3x3_stem::f32::stem_fp32_kernel<1, true>(float const*, float const*, float*, "
     "conv3x3_stem::Shape)", "conv"),
    ("void conv3x3_stem::f32::stem_fp32_kernel<3, false>(float const*, float const*, float*, "
     "conv3x3_stem::Shape)", "conv"),
    ("_ZN12conv3x3_stem11stem_kernelILi1ELb1EEEvPKtPK5uint4P13__nv_bfloat16NS_5ShapeE",
     "conv"),
    ("void conv3x3_igemm::hopper::conv3x3_wgmma<64, 128, false>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int, int, int)", "conv"),
    ("void cudnn::cnn::wgrad_alg1_nd_float_engine<float, 3, 1, 0, 2, 0, false>(int, int, int, "
     "float const*, int, float*, float const*, kernel_grad_params, unsigned long long, int, "
     "float, int)", "library"),
    ("void cudnn::cnn::wgrad2d_grouped_direct_kernel<false, true, float, float, float>"
     "(cudnn::cnn::WgradGroupedDirectParams, float const*, float const*, float*, float, float)",
     "library"),
    ("void row_moments_kernel<__nv_bfloat16>(...)", "moments")])
def test_kernel_group_files_stems_and_cudnn_wgrad(name, group):
    """The benchmark's trace files the stem kernels of both dtypes, mangled
    or not, under the port's convs, not under the library's, and cuDNN's
    weight-gradient kernels under the library's, not under "other"."""
    from benchmark import trace
    assert trace.kernel_group(name) == group

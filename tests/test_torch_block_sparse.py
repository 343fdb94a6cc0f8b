"""The port's block-sparse encoder route (`ops/block_sparse.py`, the
`ATK_BLOCK_SPARSE=1` route of `ssl/sparse.py`) against the JAX package's on
the CPU, on the same numpy inputs and converted parameters: the building
blocks one by one (indices, gather and scatter bit-equal, the halo exact),
the padded convs' plain versions, the bf16 per-tap rounding of the block
conv, the encoder with the flag (fp32, with and without remat), the port's
block route against its own dense route, the rules of `block_stage_count`,
and a tiny AnatoMask step with the flag. JAX's functions run as
`tests/test_block_sparse.py` runs them, the flag set with monkeypatch."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as fn

from anatomask_tpu.ops import block_sparse as jbs
from anatomask_tpu.ssl import sparse as jsp
from anatomask_torch import convert
from anatomask_torch.models import layers
from anatomask_torch.ops import block_sparse as tbs
from anatomask_torch.ops.conv3x3 import conv3d_3x3_plain
from anatomask_torch.ops.zslab_conv import conv3d_zslab_plain
from anatomask_torch.ssl import sparse as tsp

from torch_parity import mask_nd, mask_port, numpy_params, random_keep


@pytest.fixture(scope="module")
def case():
    """tests/test_block_sparse.py's case: 2 samples, a 3x4x3 grid of 4^3
    blocks, 13 active, 3 channels, zero outside the active blocks."""
    rng = np.random.RandomState(0)
    B, grid, bs, C, K = 2, (3, 4, 3), 4, 3, 13
    gz, gy, gx = grid
    n = gz * gy * gx
    idx = np.stack([np.sort(rng.choice(n, K, replace=False)) for _ in range(B)])
    active = np.zeros((B, n), bool)
    for b in range(B):
        active[b, idx[b]] = True
    x = rng.rand(B, gz * bs, gy * bs, gx * bs, C).astype(np.float32)
    act = active.reshape(B, gz, 1, gy, 1, gx, 1, 1)
    x = (x.reshape(B, gz, bs, gy, bs, gx, bs, C) * act).reshape(x.shape)
    return x, idx, active.reshape(B, gz, gy, gx), grid, bs, K


def _blocks(case):
    x, idx, _, grid, bs, _ = case
    jb = jbs.block_gather(jnp.asarray(x), jnp.asarray(idx, jnp.int32), grid, bs)
    tb = tbs.block_gather(torch.from_numpy(x), torch.from_numpy(idx), grid, bs)
    return jb, tb


def test_active_block_indices_match(case):
    _, idx, active, _, _, K = case
    want = jbs.active_block_indices(mask_nd(active), K)
    got = tbs.active_block_indices(mask_port(active), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), idx)


def test_gather_and_scatter_bit_equal(case):
    x, idx, _, grid, bs, _ = case
    jb, tb = _blocks(case)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    back = tbs.block_scatter(tb, torch.from_numpy(idx), grid, bs)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jbs.block_scatter(jb, jnp.asarray(idx), grid, bs)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_neighbor_table_matches_jax_dict(case):
    _, idx, _, grid, _, _ = case
    want = jbs.neighbor_positions(jnp.asarray(idx, jnp.int32), grid)
    got = tbs.neighbor_positions(torch.from_numpy(idx), grid)
    assert got.shape == (*idx.shape, 26)
    assert tuple(want) == tbs.DIRECTIONS  # the dict's order is the table's
    for i, d in enumerate(tbs.DIRECTIONS):
        np.testing.assert_array_equal(got[:, :, i].numpy(), np.asarray(want[d]))
        assert tbs.DIRECTIONS[25 - i] == tuple(-v for v in d)


def test_halo_exchange_exact_and_its_backward(case):
    """The halo equals JAX's bit for bit. Its gradient (the 26 directions'
    pieces added in fp32 in JAX's order) matches jax.vjp's, which XLA adds by
    scatter in its own order: in fp32 the two differ by at most 2 ulp of the
    largest entry (measured: 0 on this case); two backward passes give the
    same bits."""
    _, idx, _, grid, _, _ = case
    jb, tb = _blocks(case)
    jnb = jbs.neighbor_positions(jnp.asarray(idx, jnp.int32), grid)
    tnb = tbs.neighbor_positions(torch.from_numpy(idx), grid)
    jh, vjp = jax.vjp(jax.jit(lambda b: jbs.halo_exchange(b, jnb)), jb)
    tb = tb.clone().requires_grad_(True)
    th = tbs.halo_exchange(tb, tnb)
    np.testing.assert_array_equal(th.detach().numpy(), np.asarray(jh))
    g = np.random.RandomState(3).randn(*th.shape).astype(np.float32)
    want, = vjp(jnp.asarray(g))
    got, = torch.autograd.grad(th, tb, torch.from_numpy(g), retain_graph=True)
    again, = torch.autograd.grad(th, tb, torch.from_numpy(g))
    assert torch.equal(got, again)
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2 * np.finfo(np.float32).eps * scale


def _dhwio(rs, C, F, k=3):
    return (rs.randn(k, k, k, C, F) * 0.2).astype(np.float32)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def test_block_convs_and_moments_match_jax(case):
    """block_conv3 (forward, dx, dw), block_conv3_s2, block_conv1x1 at both
    strides and block_moments, fp32, within 1e-5 of the largest entry."""
    _, idx, _, grid, _, _ = case
    jb, tb = _blocks(case)
    jnb = jbs.neighbor_positions(jnp.asarray(idx, jnp.int32), grid)
    tnb = tbs.neighbor_positions(torch.from_numpy(idx), grid)
    rs = np.random.RandomState(4)
    k3, k1 = _dhwio(rs, 3, 5), _dhwio(rs, 3, 5, 1)
    jh = jbs.halo_exchange(jb, jnb)
    th = tbs.halo_exchange(tb, tnb).detach()

    jy, vjp = jax.vjp(jax.jit(jbs.block_conv3), jh, jnp.asarray(k3))
    thg, tk = th.clone().requires_grad_(True), torch.from_numpy(k3).requires_grad_(True)
    ty = tbs.block_conv3(thg, tk)
    _close(ty.detach().numpy(), jy, 1e-5)
    g = rs.randn(*ty.shape).astype(np.float32)
    jdx, jdk = vjp(jnp.asarray(g))
    tdx, tdk = torch.autograd.grad(ty, (thg, tk), torch.from_numpy(g))
    _close(tdx.numpy(), jdx, 1e-5)
    _close(tdk.numpy(), jdk, 1e-5)

    _close(tbs.block_conv3_s2(th, torch.from_numpy(k3)).numpy(),
           jbs.block_conv3_s2(jh, jnp.asarray(k3)), 1e-5)
    for stride in (1, 2):
        _close(tbs.block_conv1x1(tb, torch.from_numpy(k1), stride).numpy(),
               jbs.block_conv1x1(jb, jnp.asarray(k1), stride), 1e-5)
    for got, want in zip(tbs.block_moments(tb), jbs.block_moments(jb)):
        _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("padding", [0, 1, 2])
def test_padded_plain_convs_match_conv3d(padding):
    """Both plain versions at padding p: output extent = input + 2p - 2,
    against F.conv3d at that padding in fp32."""
    rs = np.random.RandomState(10 + padding)
    x = torch.from_numpy(rs.randn(2, 6, 7, 8, 3).astype(np.float32))
    w = torch.from_numpy(_dhwio(rs, 3, 4))
    want = fn.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), None, 1,
                     padding).permute(0, 2, 3, 4, 1)
    for plain in (conv3d_3x3_plain, conv3d_zslab_plain):
        got = plain(x, w, padding)
        assert got.shape == want.shape == (2, 4 + 2 * padding, 5 + 2 * padding, 6 + 2 * padding, 4)
        _close(got.numpy(), want.numpy(), 1e-5)


def test_block_conv_bf16_rounds_per_tap_as_jax():
    """bf16 halo'd blocks: the port's block_conv3 (kernel #2's plain version at
    padding 0) is bit-equal to JAX's block_conv3 (conv3d_zconcat_folded, each
    z-tap rounded, taps added in bf16) on >= 95% of the elements, and one
    rounding from fp32 on at least 10 points fewer."""
    rs = np.random.RandomState(5)
    blocks = np.asarray(jnp.asarray(rs.randn(2, 3, 10, 10, 10, 16), jnp.bfloat16))
    kern = np.asarray(jnp.asarray(_dhwio(rs, 16, 16), jnp.bfloat16))
    want = np.asarray(jbs.block_conv3(jnp.asarray(blocks), jnp.asarray(kern))).astype(np.float32)
    tb = torch.from_numpy(blocks.astype(np.float32)).to(torch.bfloat16)
    tk = torch.from_numpy(kern.astype(np.float32)).to(torch.bfloat16)
    got = tbs.block_conv3(tb, tk).float().numpy()
    once = conv3d_3x3_plain(tb.reshape(6, 10, 10, 10, 16), tk, 0).float().numpy()
    share = float(np.mean(got == want))
    assert share >= 0.95, share
    assert float(np.mean(once.reshape(want.shape) == want)) <= share - 0.1


# encoder: dims (4, 6, 8, 8, 8) on 32^3, a 2x2x2 patch grid of 16^3 blocks
# with 3 visible
DIMS, INPUT, GRID, KEEP = (4, 6, 8, 8, 8), 32, (2, 2, 2), 3


def _encoder_case(depth, remat):
    """The JAX encoder (without remat: nn.remat recomputes the same values,
    and compiles 2-3x slower on the CPU), its parameters, the port's encoder
    (remat as asked) on them, the input, mask and feature weights."""
    rs = np.random.RandomState(7)
    keep = random_keep(rs, 2, GRID, KEEP)
    r = INPUT // GRID[0]
    x = rs.rand(2, INPUT, INPUT, INPUT, 1).astype(np.float32)
    x = x * np.repeat(np.repeat(np.repeat(keep, r, 1), r, 2), r, 3)[..., None]
    depths = (depth,) * 2 + (1,) * 3  # the two block stages at `depth`
    jenc = jsp.SparseSTUNetEncoder(depth=depths, dims=DIMS, len_keep=KEEP)
    params = numpy_params(jenc, 8, jnp.asarray(x), mask_nd(keep))
    tenc = tsp.SparseSTUNetEncoder(1, DIMS, depth=depths, remat=remat, len_keep=KEEP)
    sd = convert.from_jax("spark", {"sparse_encoder": params})
    tenc.load_state_dict({k.removeprefix("sparse_encoder.sp_cnn."): v for k, v in sd.items()})
    ws = [rs.randn(2, INPUT >> d, INPUT >> d, INPUT >> d, c).astype(np.float32)
          for d, c in enumerate(DIMS)]
    return x, keep, jenc, params, tenc, ws


def _jax_encoder(jenc, params, x, keep, ws):
    """JAX's features and the gradient of sum(feature * w) in its params."""
    def loss(p):
        feats = jenc.apply({"params": p}, jnp.asarray(x), mask_nd(keep))
        return sum(jnp.sum(f * w) for f, w in zip(feats, ws)), feats

    (_, feats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    grads = convert.from_jax("spark", {"sparse_encoder": grads})
    return ([np.asarray(f) for f in feats],
            {k.removeprefix("sparse_encoder.sp_cnn."): v.numpy() for k, v in grads.items()})


def _port_encoder(tenc, x, keep, ws):
    tenc.zero_grad()
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(memory_format=torch.channels_last_3d)
    feats = tenc(xt, mask_port(keep))
    sum((f * torch.from_numpy(w).permute(0, 4, 1, 2, 3)).sum() for f, w in zip(feats, ws)).backward()
    return ([f.detach().permute(0, 2, 3, 4, 1).numpy() for f in feats],
            {n: p.grad.clone().numpy() for n, p in tenc.named_parameters()})


# every leaf within _GRAD_ATOL of the largest gradient entry (measured
# against JAX: at most 1.94e-6 at depth 1 and 6.06e-6 at depth 2). A conv
# bias right before an instance norm has a zero gradient, round-off in both
# frameworks, which must vanish in both (<= _GRAD_ATOL of the largest
# gradient: here the loss weights every feature voxel, and the round-off
# reaches 2.54e-6 at depth 1 and 5.01e-6 at depth 2, JAX's own included);
# every other leaf also within _GRAD_RTOL of its own largest entry, twice
# the worst measured gap (2.36e-5 at depth 1, 6.72e-5 at depth 2, the
# latter in the dense stage 4's conv1 weight)
_CANCELLED = re.compile(r"conv_blocks_context\.\d+\.\d+\.conv[12]\.bias")
_GRAD_ATOL = 1e-5
_GRAD_RTOL = 1.5e-4
ROUND_OFF = 1e-6  # a gradient of pure round-off (test_torch_multinode.py's floor)


def _close_grads(got, want):
    assert set(got) == set(want)
    g_max = max(np.abs(v).max() for v in want.values())
    for name, r in want.items():
        g = got[name]
        if _CANCELLED.fullmatch(name):
            assert max(np.abs(g).max(), np.abs(r).max()) <= _GRAD_ATOL * g_max, name
        else:
            assert np.abs(g - r).max() <= _GRAD_ATOL * g_max, name
            assert np.abs(g - r).max() <= _GRAD_RTOL * np.abs(r).max(), name


@pytest.mark.parametrize("depth,remat", [(1, False), (2, True)])
def test_encoder_with_the_flag_matches_jax(monkeypatch, depth, remat):
    """With ATK_BLOCK_SPARSE=1 in both packages (two block stages): every
    feature within 1e-5 of its largest entry, every gradient within 1e-5 of
    the largest gradient entry and within _GRAD_RTOL of its own; at depth 2
    the port's encoder runs with remat, and its gradients are also bit-equal
    to its own without."""
    monkeypatch.setenv("ATK_BLOCK_SPARSE", "1")
    x, keep, jenc, params, tenc, ws = _encoder_case(depth, remat)
    assert tenc._block_stage_count(torch.zeros(1, 1, INPUT, INPUT, INPUT), mask_port(keep)) == 2
    want_f, want_g = _jax_encoder(jenc, params, x, keep, ws)
    got_f, got_g = _port_encoder(tenc, x, keep, ws)
    for got, want in zip(got_f, want_f):
        _close(got, want, 1e-5)
    _close_grads(got_g, want_g)
    if remat:
        tenc.remat = False
        _, plain_g = _port_encoder(tenc, x, keep, ws)
        for name, g in got_g.items():
            np.testing.assert_array_equal(g, plain_g[name], err_msg=name)


def test_block_route_matches_the_dense_route(monkeypatch):
    """The port's block route against its own dense route in fp32, at JAX's
    tolerance (tests/test_block_sparse.py: rtol 1e-4, atol 1e-5)."""
    x, keep, _, _, tenc, ws = _encoder_case(1, False)
    dense_f, dense_g = _port_encoder(tenc, x, keep, ws)
    monkeypatch.setenv("ATK_BLOCK_SPARSE", "1")
    block_f, block_g = _port_encoder(tenc, x, keep, ws)
    for got, want in zip(block_f, dense_f):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    _close_grads(block_g, dense_g)


@pytest.mark.parametrize("depth", [1, 2])
def test_block_route_matches_the_dense_route_in_float64(monkeypatch, depth):
    """The witness for the block route's fp32 gaps (every gradient leaf
    within 1e-5 of the largest entry, but up to 2.36e-5 and 6.72e-5 of its
    own largest against JAX at depths 1 and 2): the same case in float64,
    the 3x3x3 convs and norm sums of both routes swapped for float64 library
    versions of the same functions (tests/torch_ddp_cases.py's, as
    test_torch_multinode.py's float64 witness swaps them). The block route
    against the dense route: every feature and every gradient leaf within
    1e-5 of its own largest entry (a leaf of pure round-off, a conv bias
    that a norm cancels, of ROUND_OFF times the largest gradient entry). So
    what parts the fp32 routes is fp32 summation order."""
    from torch_ddp_cases import _conv3x3_64, _row_moments_64
    for module, name, f in ((layers, "conv3d_3x3", _conv3x3_64),
                            (layers, "conv3d_zconcat", _conv3x3_64),
                            (tbs, "conv3d_zconcat", _conv3x3_64),
                            (layers, "row_moments", _row_moments_64),
                            (tsp, "row_moments", _row_moments_64),
                            (tbs, "row_moments", _row_moments_64)):
        monkeypatch.setattr(module, name, f)
    x, keep, _, _, tenc, ws = _encoder_case(depth, False)
    tenc.double()
    for m in tenc.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    x = x.astype(np.float64)
    dense_f, dense_g = _port_encoder(tenc, x, keep, ws)
    assert all(g.dtype == np.float64 for g in dense_g.values())
    monkeypatch.setenv("ATK_BLOCK_SPARSE", "1")
    assert tenc._block_stage_count(torch.zeros(1, 1, INPUT, INPUT, INPUT), mask_port(keep)) == 2
    block_f, block_g = _port_encoder(tenc, x, keep, ws)
    for got, want in zip(block_f, dense_f):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    g_max = max(np.abs(v).max() for v in dense_g.values())
    for name, want in dense_g.items():
        gap = np.abs(block_g[name] - want).max()
        assert gap <= 1e-5 * max(np.abs(want).max(), ROUND_OFF * g_max), (name, gap)


_STRIDES = {"stunet": None, "first strided": [(2, 2, 2)] * 5,
            "anisotropic": [(1, 1, 1), (2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)],
            "third anisotropic": [(1, 1, 1), (2, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2)]}
_SHAPES = {"cubic": ((32, 32, 32), (2, 2, 2)), "bench": ((112, 112, 128), (7, 7, 8)),
           "non-cubic blocks": ((32, 32, 48), (2, 2, 2)), "ragged": ((33, 32, 32), (2, 2, 2)),
           "8^3 blocks": ((16, 16, 16), (2, 2, 2)), "4^3 blocks": ((8, 8, 8), (2, 2, 2))}


@pytest.mark.parametrize("stages", [None, "0", "1", "2", "3", "5"])
def test_block_stage_count_matches_jax(monkeypatch, stages):
    """block_stage_count against JAX's _block_stage_count over input shapes,
    stride tables, ATK_BLOCK_SPARSE_STAGES and norm_batch_pooled, with the
    flag on and off."""
    if stages is not None:
        monkeypatch.setenv("ATK_BLOCK_SPARSE_STAGES", stages)
    seen = set()
    for flag in ("0", "1"):
        monkeypatch.setenv("ATK_BLOCK_SPARSE", flag)
        for strides in _STRIDES.values():
            for pooled in (False, True):
                jenc = jsp.SparseSTUNetEncoder(dims=DIMS, len_keep=KEEP, pool_op_kernel_sizes=strides,
                                               norm_batch_pooled=pooled)
                for shape, grid in _SHAPES.values():
                    want = jenc._block_stage_count(np.zeros((1, *shape, 1)),
                                                   np.zeros((1, *grid, 1), bool))
                    got = tsp.block_stage_count(shape, grid, jenc._strides(), jenc._kernels(),
                                                KEEP, pooled)
                    assert got == want, (flag, strides, pooled, shape)
                    seen.add(got)
    tenc = tsp.SparseSTUNetEncoder(1, DIMS, len_keep=None)
    assert tenc._block_stage_count(torch.zeros(1, 1, 32, 32, 32),
                                   torch.zeros(1, 1, 2, 2, 2, dtype=torch.bool)) == 0
    # the shapes allow at most 3 block stages (16^3 blocks: 16, 8, 4)
    assert seen == set(range(min(int(stages or 2), 3) + 1))


def _jax_step_loss(model, params, ema_params, x, key, len_loss):
    """tests/test_torch_step.py's JAX step up to the student's loss, jitted:
    the teacher under a random mask, the hard mask from its loss map, the
    student's loss under it; with the noise of both draws."""
    from anatomask_tpu.ssl.anatomask import generate_guided_mask
    from anatomask_tpu.ssl.spark import spark_loss

    k1, k2 = jax.random.split(key)
    # one compiled forward + loss serves the teacher and the student
    fwd = jax.jit(lambda p, xb, m: spark_loss(*model.apply({"params": p}, xb, m), m))
    mask1 = model.mask(k1, x.shape[0])
    _, loss_map = fwd(ema_params, x, mask1)
    hard, _ = generate_guided_mask(k2, loss_map, model.fmap, model.len_keep, len_loss)
    loss, _ = fwd(params, x, hard)
    L = int(np.prod(model.fmap))
    noise = np.stack([np.asarray(jax.random.uniform(k, (x.shape[0], L))) for k in (k1, k2)])
    return dict(loss=float(loss), hard=np.asarray(hard)[..., 0], noise=noise)


def test_anatomask_step_with_the_flag_matches_jax(monkeypatch):
    """A tiny AnatoMask step (tests/test_torch_step.py's, with four stages,
    dims 4-32 on 16^3: two block stages of 8^3 and 4^3 blocks) with
    ATK_BLOCK_SPARSE=1 in both packages: the same hard mask, the loss within
    1e-5."""
    from torch_parity import jax_build_spark_model, port_model, tiny_configs, to_ncdhw
    from anatomask_torch.ssl.pretrain import anatomask_train_step, make_optimizer, make_teacher

    monkeypatch.setenv("ATK_BLOCK_SPARSE", "1")
    jcfg, tcfg = tiny_configs((4, 8, 16, 32), (16, 16, 16))
    jmodel = jax_build_spark_model(jcfg)
    init = (jnp.zeros((1, 16, 16, 16, 1)), jmodel.mask(jax.random.PRNGKey(0), 1))
    params, ema = numpy_params(jmodel, 31, *init), numpy_params(jmodel, 32, *init)
    x = np.random.RandomState(33).rand(2, 16, 16, 16, 1).astype(np.float32)
    ref = _jax_step_loss(jmodel, params, ema, jnp.asarray(x), jax.random.PRNGKey(34), 1)
    student = port_model(params, tcfg)
    assert student.sparse_encoder.sp_cnn._block_stage_count(
        torch.zeros(1, 1, 16, 16, 16), torch.zeros(1, 1, 2, 2, 2, dtype=torch.bool)) == 2
    teacher = make_teacher(port_model(ema, tcfg))
    loss, hard, _ = anatomask_train_step(student, teacher, make_optimizer(student), to_ncdhw(x),
                                         1, noise=torch.from_numpy(ref["noise"]))
    np.testing.assert_array_equal(hard[:, 0].numpy(), ref["hard"])
    np.testing.assert_allclose(loss.item(), ref["loss"], rtol=1e-5)

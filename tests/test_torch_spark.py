"""anatomask_torch's SparK path against anatomask_tpu on the CPU, float32:
weight conversion, the full masked forward, the loss, masks, norms and the
blocks around them. Inputs and noise come from numpy seeds and go to both."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.models import layers as jl
from anatomask_tpu.ssl import anatomask as ja
from anatomask_tpu.ssl import ema as jema
from anatomask_tpu.ssl import spark as js
from anatomask_tpu.ssl import sparse as jsp
from anatomask_tpu.ssl.decoder import ConvTranspose2x as JConvTranspose2x
from anatomask_tpu.training.checkpoint import convert_torch_spark_state_dict, flatten_tree
from anatomask_torch.models import layers as tl
from anatomask_torch.ssl import anatomask as ta
from anatomask_torch.ssl import ema as tema
from anatomask_torch.ssl import spark as ts
from anatomask_torch.ssl import sparse as tsp
from anatomask_torch.ssl.decoder import ConvTranspose2x

from torch_parity import (BATCH, PATCH, jax_build_spark_model, jax_params, mask_nd,
                          mask_port, port_model, random_keep, tiny_configs, to_ncdhw)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    jmodel = jax_build_spark_model(jcfg)
    params = jax_params(jmodel, seed=3)
    return jmodel, params, port_model(params, tcfg)


def test_state_dict_round_trip(models):
    _, params, tmodel = models
    back = flatten_tree(convert_torch_spark_state_dict(tmodel.state_dict()))
    ref = flatten_tree(params)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture(scope="module")
def forward_pair(models):
    jmodel, params, tmodel = models
    rs = np.random.RandomState(11)
    x = rs.rand(BATCH, *PATCH, 1).astype(np.float32)
    keep = random_keep(rs, BATCH, jmodel.fmap, jmodel.len_keep)
    inp_j, rec_j = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), mask_nd(keep))
    with torch.no_grad():
        inp_t, rec_t = tmodel(to_ncdhw(x), mask_port(keep))
    return keep, (np.asarray(inp_j), np.asarray(rec_j)), (inp_t.numpy(), rec_t.numpy())


@pytest.mark.parametrize("which", ["inp", "rec"])
def test_forward_matches_jax(forward_pair, which):
    _, jout, tout = forward_pair
    i = ["inp", "rec"].index(which)
    assert tout[i].shape == jout[i].shape
    np.testing.assert_allclose(tout[i], jout[i], rtol=1e-4, atol=1e-5)


def test_spark_loss_matches_jax(forward_pair):
    keep, (inp, rec), _ = forward_pair
    loss_j, map_j = js.spark_loss(jnp.asarray(inp), jnp.asarray(rec), mask_nd(keep))
    loss_t, map_t = ts.spark_loss(torch.tensor(inp), torch.tensor(rec),
                                  mask_port(keep))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(map_t.numpy(), np.asarray(map_j), rtol=1e-5, atol=1e-7)


def test_learning_loss_matches_jax():
    rs = np.random.RandomState(5)
    pred, target = rs.rand(2, 3, 40).astype(np.float32)
    ref = js.learning_loss(jnp.asarray(pred), jnp.asarray(target))
    got = ts.learning_loss(torch.from_numpy(pred), torch.from_numpy(target))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_patchify_matches_jax_and_inverts():
    rs = np.random.RandomState(2)
    x = rs.rand(2, 8, 12, 16, 3).astype(np.float32)
    fmap, p = (2, 3, 4), (4, 4, 4)
    ref = np.asarray(js.patchify(jnp.asarray(x), fmap, p))
    got = ts.patchify(to_ncdhw(x), fmap, p)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ts.unpatchify(got, fmap, p).numpy(),
                                  x.transpose(0, 4, 1, 2, 3))


def test_random_keep_mask_bit_equal_with_shared_noise():
    key = jax.random.PRNGKey(9)
    fmap, len_keep = (3, 4, 5), 24
    ref = np.asarray(js.random_keep_mask(key, 3, fmap, len_keep))[..., 0]
    noise = torch.tensor(np.asarray(jax.random.uniform(key, (3, 60))))
    got = ts.random_keep_mask(3, fmap, len_keep, noise=noise)[:, 0].numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("len_loss", [0, 1, 9, 20])
def test_guided_mask_bit_equal_with_shared_noise(len_loss):
    fmap = (7, 7, 8)
    L, len_keep = 392, 157
    rs = np.random.RandomState(len_loss)
    loss_pred = rs.rand(3, L).astype(np.float32)
    key = jax.random.PRNGKey(len_loss)
    hard_j, easy_j = ja.generate_guided_mask(key, jnp.asarray(loss_pred), fmap, len_keep,
                                             len_loss)
    noise = torch.tensor(np.asarray(jax.random.uniform(key, (3, L))))
    hard_t, easy_t = ta.generate_guided_mask(torch.from_numpy(loss_pred), fmap, len_keep,
                                             len_loss, noise=noise)
    np.testing.assert_array_equal(hard_t[:, 0].numpy(), np.asarray(hard_j)[..., 0])
    np.testing.assert_array_equal(easy_t[:, 0].numpy(), np.asarray(easy_j)[..., 0])


def test_guided_mask_rules_with_its_own_noise():
    fmap, L, len_keep, len_loss = (7, 7, 8), 392, 157, 58
    loss_pred = torch.from_numpy(np.random.RandomState(4).rand(4, L).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    hard, easy = ta.generate_guided_mask(loss_pred, fmap, len_keep, len_loss, gen)
    hard = hard.reshape(4, L)
    assert hard.sum(1).tolist() == [len_keep] * 4
    assert easy.reshape(4, L).sum(1).tolist() == [len_keep + len_loss] * 4
    top = torch.topk(loss_pred, len_loss, dim=1).indices
    assert not torch.gather(hard, 1, top).any()


def test_guided_keep_ratio_and_ema_schedule():
    for epoch, total in [(0, 200), (99, 200), (199, 200)]:
        assert ta.guided_keep_ratio(epoch, total) == ja.guided_keep_ratio(epoch, total)
        assert tema.ema_decay_schedule(epoch, total) == pytest.approx(
            jema.ema_decay_schedule(epoch, total), rel=1e-12)
    assert ta.guided_keep_ratio(3, 10, guide=False) == ja.guided_keep_ratio(3, 10, False)


def test_ema_update_matches_jax():
    rs = np.random.RandomState(6)
    e, p = rs.randn(2, 5, 7).astype(np.float32)
    ref = np.asarray(jema.ema_update({"a": jnp.asarray(e)}, {"a": jnp.asarray(p)}, 0.999)["a"])
    teacher, student = torch.nn.Linear(7, 5, bias=False), torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        teacher.weight.copy_(torch.from_numpy(e))
        student.weight.copy_(torch.from_numpy(p))
    tema.ema_update(teacher, student, 0.999)
    np.testing.assert_allclose(teacher.weight.detach().numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch_pooled", [False, True])
def test_sparse_instance_norm_matches_jax(batch_pooled):
    rs = np.random.RandomState(8)
    x = (rs.rand(3, 4, 4, 6, 5) * 5).astype(np.float32)
    keep = rs.rand(3, 2, 2, 3) > 0.4
    scale, bias = rs.randn(2, 5).astype(np.float32)
    mod = jsp.SparseInstanceNorm(epsilon=1e-6, batch_pooled=batch_pooled)
    ref = mod.apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x), mask_nd(keep))
    norm = tsp.SparseInstanceNorm(5, eps=1e-6, batch_pooled=batch_pooled)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(to_ncdhw(x), mask_port(keep))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_instance_norm_matches_jax():
    rs = np.random.RandomState(12)
    x = (rs.rand(2, 4, 6, 8, 3) * 3).astype(np.float32)
    scale, bias = rs.randn(2, 3).astype(np.float32)
    ref = jl.InstanceNorm().apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    norm = tl.InstanceNorm(3)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        got = norm(to_ncdhw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_sparse_res_block_matches_jax(stride):
    rs = np.random.RandomState(13 + stride)
    x = rs.rand(2, 8, 8, 8, 3).astype(np.float32)
    keep = rs.rand(2, 2, 2, 2) > 0.4
    m = np.repeat(np.repeat(np.repeat(keep, 4, 1), 4, 2), 4, 3)[..., None]
    x = x * m  # block input is zero outside the visible voxels
    mod = jsp.SparseBasicResBlock(6, (3, 3, 3), (stride,) * 3, use_1x1conv=True)
    with jax.disable_jit():
        params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), mask_nd(keep))["params"]
        params = jax.tree_util.tree_map(
            lambda v: np.asarray(v) + 0.05 * rs.standard_normal(v.shape).astype(np.float32),
            params)
        ref = mod.apply({"params": params}, jnp.asarray(x), mask_nd(keep))
    block = tsp.SparseBasicResBlock(3, 6, stride, use_1x1conv=True)
    sd = {}
    for layer in ("conv1", "conv2", "conv3"):
        sd[f"{layer}.weight"] = params[layer]["conv"]["kernel"].transpose(4, 3, 0, 1, 2)
        sd[f"{layer}.bias"] = params[layer]["conv"]["bias"]
    for layer in ("norm1", "norm2"):
        sd[f"{layer}.weight"], sd[f"{layer}.bias"] = params[layer]["scale"], params[layer]["bias"]
    block.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    with torch.no_grad():
        got = block(to_ncdhw(x), mask_port(keep))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)


def test_conv_transpose_matches_jax():
    rs = np.random.RandomState(14)
    x = rs.rand(2, 3, 4, 5, 6).astype(np.float32)
    k = (0.1 * rs.randn(4, 4, 4, 6, 5)).astype(np.float32)
    b = rs.randn(5).astype(np.float32)
    params = {"conv": {"kernel": k, "bias": b}}
    with jax.disable_jit():
        ref = JConvTranspose2x(5).apply({"params": params}, jnp.asarray(x))
    up = ConvTranspose2x(6, 5)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(np.flip(k, (0, 1, 2)).transpose(3, 4, 0, 1, 2).copy()))
        up.bias.copy_(torch.from_numpy(b))
        got = up(to_ncdhw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_upsample_mask_matches_jax():
    keep = np.random.RandomState(15).rand(2, 2, 3, 2) > 0.5
    ref = np.asarray(jsp.mask_to_resolution(mask_nd(keep), (4, 9, 8)))[..., 0]
    got = tsp.mask_to_resolution(mask_port(keep), (4, 9, 8))[:, 0].numpy()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        tsp.mask_to_resolution(mask_port(keep), (5, 9, 8))

"""Every pretraining configuration that the JAX package's PretrainConfig builds,
in anatomask_torch against anatomask_tpu on the CPU in float32: the SparK's
forward, loss and gradients at encoder depths 2 and 3, densify norms "in",
"bn" and "ln", decoder norms "in" and "bn", the batch-pooled
reference-fidelity mode and the MedNeXt encoder; the modules of the slice on
their own (the ablation decoders, GRN, SparseGRN, the ConvNeXt block, the
pools, the group and layer norms, SparseBatchNorm);
weight decay masks and converter round trips on every new module's tree;
activation checkpointing (remat) against the plain gradients, bit for bit;
and AnatoMask's encoder transfer at STUNet-L and -H depths.

Parameters are drawn with numpy from a seed (no flax initialisation) and
carried across by `convert.from_jax`. Tolerances:
- the SparK's reconstruction within 1e-5 of its largest entry and the loss
  within rtol 1e-5 (tests/test_torch_spark.py's loss limit; its forward limit
  is elementwise, too tight for these models' O(10) outputs);
- a gradient leaf within 7.1e-3 of its own largest entry (the limit of
  tests/test_torch_step.py) plus its flip reach: a LeakyReLU or ReLU6 input
  within float32 round-off of a branch point may take the other branch in
  one package (against a float64 JAX run, the flipped inputs lay within
  2.4e-6 of 0). The reach is measured on the port itself: the gradients
  with every activation input within 1e-5 of a branch point (the point
  itself excepted) put on one side, minus those with all of them on the
  other. Every leaf's limit must stay below half its largest entry, so a
  leaf that is zero or of the wrong sign fails whatever the reach;
- a conv bias that a norm cancels below 1e-6 of the step's largest gradient
  in both packages;
- the standalone modules' outputs and gradients within 1e-5 of their largest
  entry."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as fn

from anatomask_tpu.ssl import decoder as jdec
from anatomask_tpu.ssl import sparse as jsp
from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_tpu.ssl.pretrain import no_decay_mask as jax_no_decay_mask
from anatomask_tpu.ssl.spark import spark_loss as jax_spark_loss
from anatomask_tpu.training import checkpoint as jck
from anatomask_torch import convert
from anatomask_torch.models.plain_unet import PlainConvUNet, ResidualEncoderUNet
from anatomask_torch.models.stunet import STUNet
from anatomask_torch.ssl import decoder as tdec
from anatomask_torch.ssl import sparse as tsp
from anatomask_torch.ssl.pretrain import PretrainConfig, build_spark_model, no_decay_mask
from anatomask_torch.ssl.spark import spark_loss
from anatomask_torch.training import checkpoint as tck

from torch_parity import mask_nd, mask_port, numpy_params, random_keep, to_ncdhw

THREADS = 4  # torch's CPU sums split by thread count; pinned as in test_torch_step.py
BATCH = 2
SMALL = dict(encoder_dims=(4, 8, 16), patch_size=(32, 32, 32))
# name -> PretrainConfig fields (both packages take the same)
CONFIGS = {
    "depth2-densify_bn": dict(SMALL, encoder_depth=(2, 2, 2), densify_norm="bn"),
    "depth3-densify_ln-decoder_bn-remat": dict(SMALL, encoder_depth=(3, 3, 3),
                                               densify_norm="ln", decoder_norm="bn",
                                               remat=True),
    "pooled-densify_in-decoder_bn": dict(SMALL, norm_batch_pooled=True, decoder_norm="bn"),
    "mednext": dict(encoder_type="mednext", encoder_dims=(2,), decoder_width=32,
                    patch_size=(64, 64, 64)),
}
_GRAD_RTOL = 7.1e-3  # of the leaf's largest gradient
_BAND = 1e-5  # activation inputs this close to a branch point may take either branch
# conv biases that a norm over the visible voxels cancels: STUNet's conv1 and
# conv2, MedNeXt's depthwise conv1, and the last bottleneck block's conv3,
# whose output the coarsest densify InstanceNorm takes
_CANCELLED = re.compile(r"sparse_encoder\.sp_cnn\.(conv_blocks_context\.\d+\.\d+\.conv[12]"
                        r"|(enc_block_\d\.\d+|down_\d|bottleneck\.\d+)\.conv1"
                        r"|bottleneck\.1\.conv3)\.bias")


def _grads_by_name(module):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
            for n, p in module.named_parameters()}


def _close_leaves(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for k, r in want.items():
        r = np.asarray(r)
        assert np.abs(got[k] - r).max() <= rtol * np.abs(r).max(), k


def _pinned(fn):
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return fn()
    finally:
        torch.set_num_threads(saved)


class _OneSide(torch.autograd.Function):
    """LeakyReLU (branch point 0) or ReLU6 (0 and 6) whose backward takes
    every input within _BAND of a branch point, other than the point itself,
    on one side: "hi" the slope-1 branch, "lo" the other."""

    @staticmethod
    def forward(ctx, x, points, lo_slope, side):
        ctx.save_for_backward(x)
        ctx.points, ctx.lo_slope, ctx.side = points, lo_slope, side
        if len(points) == 1:
            return torch.where(x > 0, x, x * lo_slope)
        return x.clamp(*points)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if len(ctx.points) == 1:
            d = torch.where(x > 0, 1.0, ctx.lo_slope)
        else:
            d = ((x > ctx.points[0]) & (x < ctx.points[1])).to(x.dtype)
        near = torch.zeros_like(x, dtype=torch.bool)
        for q in ctx.points:
            near |= ((x - q).abs() <= _BAND) & (x != q)
        d = torch.where(near, 1.0 if ctx.side == "hi" else ctx.lo_slope, d)
        return g * d, None, None, None


def _flip_reach(run):
    """|gradients with every near-branch activation input on the slope-1 side
    - with all on the other|, leaf by leaf; `run` returns a model after its
    backward."""
    grads = []
    for side in ("lo", "hi"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fn, "leaky_relu", lambda x, negative_slope=0.01, inplace=False:
                       _OneSide.apply(x, (0.0,), negative_slope, side))
            mp.setattr(fn, "hardtanh", lambda x, min_val=-1.0, max_val=1.0, inplace=False:
                       _OneSide.apply(x, (min_val, max_val), 0.0, side))
            grads.append(_grads_by_name(_pinned(run)[0]))
    return {k: np.abs(grads[1][k] - grads[0][k]) for k in grads[0]}


# --- the SparK of each configuration -------------------------------------------------

def _configs(name):
    kw = dict(CONFIGS[name], compute_dtype="float32", batch_size=BATCH)
    if "encoder_depth" in kw:
        kw["encoder_depth"] = tuple(kw["encoder_depth"])
    return JaxPretrainConfig(**kw), PretrainConfig(**kw)


@pytest.fixture(scope="module", params=list(CONFIGS))
def spark_pair(request):
    """JAX's and the port's forward, loss and gradients of one configuration
    on the same weights, input and mask."""
    jcfg, tcfg = _configs(request.param)
    jmodel = jax_build_spark_model(jcfg)
    rs = np.random.RandomState(7)
    keep = random_keep(rs, BATCH, jmodel.fmap, jmodel.len_keep)
    x = rs.rand(BATCH, *jcfg.patch_size, 1).astype(np.float32)
    params = numpy_params(jmodel, 8, jnp.zeros((1, *jcfg.patch_size, 1)), mask_nd(keep[:1]))

    def loss_fn(p):
        inp, rec = jmodel.apply({"params": p}, jnp.asarray(x), mask_nd(keep))
        return jax_spark_loss(inp, rec, mask_nd(keep))[0], rec

    (loss, rec), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)

    def port():
        model = build_spark_model(tcfg, device="cpu")
        model.load_state_dict(convert.from_jax("spark", params))
        inp_t, rec_t = model(to_ncdhw(x), mask_port(keep))
        loss_t = spark_loss(inp_t, rec_t, mask_port(keep))[0]
        loss_t.backward()
        return model, loss_t.item(), rec_t.detach().numpy()

    model, loss_t, rec_t = _pinned(port)
    return dict(name=request.param, params=params, model=model, jcfg=jcfg, tcfg=tcfg,
                loss=(loss_t, float(loss)), rec=(rec_t, np.asarray(rec)),
                grads=(_grads_by_name(model), convert.from_jax("spark", grads)),
                reach=_flip_reach(port))


def test_spark_config_forward_matches_jax(spark_pair):
    got, want = spark_pair["rec"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_spark_config_loss_matches_jax(spark_pair):
    np.testing.assert_allclose(*spark_pair["loss"], rtol=1e-5)


def test_spark_config_gradients_match_jax(spark_pair):
    got, want = spark_pair["grads"]
    want = {k: v.numpy() for k, v in want.items()}
    assert set(got) == set(want)
    g_max = max(np.abs(r).max() for r in want.values())
    for name, r in want.items():
        if _CANCELLED.fullmatch(name):
            assert max(np.abs(got[name]).max(), np.abs(r).max()) <= 1e-6 * g_max, name
        else:
            limit = _GRAD_RTOL * np.abs(r).max() + spark_pair["reach"][name].max()
            assert limit <= 0.5 * np.abs(r).max(), name
            assert np.abs(got[name] - r).max() <= limit, name


def test_spark_config_matches_jax_config(spark_pair):
    """The built model reports what JAX's does (get_config; the checkpoint
    meta's spark_config) and has its patch grid and keep count."""
    jmodel = jax_build_spark_model(spark_pair["jcfg"])
    model = spark_pair["model"]
    assert model.get_config() == jmodel.get_config()
    assert (model.fmap, model.len_keep) == (tuple(jmodel.fmap), jmodel.len_keep)


def test_spark_config_no_decay_mask_matches_jax(spark_pair):
    params = spark_pair["params"]
    flags = jax.tree_util.tree_map(lambda d, p: np.full(np.shape(p), float(d), np.float32),
                                   jax_no_decay_mask(params), params)
    want = {k: bool(v.any()) for k, v in convert.from_jax("spark", flags).items()}
    assert no_decay_mask(spark_pair["model"]) == want


def test_spark_config_round_trips(spark_pair):
    """from_jax then to_jax is the identity on the JAX tree, and to_jax then
    from_jax on the port's state_dict, bit for bit."""
    params, model = spark_pair["params"], spark_pair["model"]
    back = jck.flatten_tree(convert.to_jax("spark", convert.from_jax("spark", params)))
    want = jck.flatten_tree(params)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    sd = model.state_dict()
    again = convert.from_jax("spark", convert.to_jax("spark", sd))
    assert set(again) == set(sd) and all(torch.equal(again[k], sd[k]) for k in sd)


def test_remat_gradients_bit_equal_spark():
    """remat (a stage and a decoder block checkpointed) changes no gradient
    bit: STUNet at depth 2 and MedNeXt, each with and without."""
    for name in ("depth2-densify_bn", "mednext"):
        _, cfg = _configs(name)
        rs = np.random.RandomState(3)
        x = to_ncdhw(rs.rand(BATCH, *cfg.patch_size, 1).astype(np.float32))
        grads = []
        for remat in (False, True):
            model = build_spark_model(PretrainConfig(**{**cfg.__dict__, "remat": remat}),
                                      device="cpu")
            keep = mask_port(random_keep(np.random.RandomState(4), BATCH, model.fmap,
                                         model.len_keep))

            def step():
                inp, rec = model(x, keep)
                spark_loss(inp, rec, keep)[0].backward()
                return _grads_by_name(model)

            grads.append(_pinned(step))
        assert grads[0].keys() == grads[1].keys()
        for k in grads[0]:
            np.testing.assert_array_equal(grads[1][k], grads[0][k], err_msg=f"{name} {k}")


@pytest.mark.parametrize("arch", ["STUNet-depth2", "PlainConvUNet", "ResidualEncoderUNet"])
def test_remat_gradients_bit_equal_supervised(arch):
    """The supervised networks' remat (STUNet a stage; the U-Nets a stage, a
    residual block) changes no gradient bit."""
    x = to_ncdhw(np.random.RandomState(5).rand(2, 16, 16, 16, 1).astype(np.float32))
    unet = dict(input_channels=1, num_classes=3, n_stages=3, features_per_stage=(4, 8, 16),
                kernel_sizes=[(3, 3, 3)] * 3, strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2)],
                n_conv_per_stage_decoder=(2, 1))
    grads = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(0)
        if arch.startswith("STUNet"):
            net = STUNet(1, 3, depth=(2,) * 4, dims=(4, 8, 16, 16),
                         pool_op_kernel_sizes=[(2, 2, 2)] * 3, generator=gen, remat=remat)
        elif arch == "PlainConvUNet":
            net = PlainConvUNet(n_conv_per_stage=(2, 2, 2), generator=gen, remat=remat, **unet)
        else:
            net = ResidualEncoderUNet(n_blocks_per_stage=(1, 2, 2), generator=gen, remat=remat,
                                      **unet)

        def step():
            sum(o.square().mean() for o in net(x)).backward()
            return _grads_by_name(net)

        grads.append(_pinned(step))
    for k in grads[0]:
        np.testing.assert_array_equal(grads[1][k], grads[0][k], err_msg=k)


# --- the modules on their own ------------------------------------------------------

def _module_case(name):
    """(JAX module, its call args as numpy, the port module, a function of the
    port module and torch args, the RULES name) of one standalone case."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 8, 8, 8, 4).astype(np.float32)
    keep = rs.rand(2, 4, 4, 4) > 0.4
    x_m = x * np.repeat(np.repeat(np.repeat(keep, 2, 1), 2, 2), 2, 3)[..., None]
    if name == "ds_decoder":
        feats = [rs.randn(2, 2, 2, 2, 16).astype(np.float32),
                 rs.randn(2, 4, 4, 4, 8).astype(np.float32)]
        return (jdec.DSDecoder(4, width=16, norm="bn"), ([*feats],),
                tdec.DSDecoder(4, width=16, norm="bn"), lambda m, f: m(f))
    if name == "smim_decoder":
        return (jdec.SMiMDecoder(16, width=16), ([rs.randn(2, 3, 3, 3, 8).astype(np.float32)],),
                tdec.SMiMDecoder(8, 16, width=16), lambda m, f: m(f))
    if name == "smim_two_decoder":
        return (jdec.SMiMTwoDecoder(16, width=64),
                ([rs.randn(2, 3, 3, 3, 8).astype(np.float32)],),
                tdec.SMiMTwoDecoder(8, 16, width=64), lambda m, f: m(f))
    if name == "grn":
        return jsp.GRN(), (x,), tsp.GRN(4), lambda m, a: m(a)
    if name == "sparse_grn":
        return jsp.SparseGRN(), (x_m, keep[..., None]), tsp.SparseGRN(4), lambda m, a, k: m(a, k)
    if name == "convnext_block":
        return (jsp.SparseConvNeXtBlock(dim=4), (x_m, keep[..., None]),
                tsp.SparseConvNeXtBlock(4), lambda m, a, k: m(a, k))
    if name == "group_norm":
        return (jsp.SparseGroupNorm(num_groups=2), (x_m, keep[..., None]),
                tsp.SparseGroupNorm(2, 4), lambda m, a, k: m(a, k))
    if name == "layer_norm":
        return (jsp.SparseLayerNorm(), (x_m, keep[..., None]), tsp.SparseLayerNorm(4),
                lambda m, a, k: m(a, k))
    raise ValueError(name)


MODULES = ["ds_decoder", "smim_decoder", "smim_two_decoder", "grn", "sparse_grn",
           "convnext_block", "group_norm", "layer_norm"]
_RULES = {"grn": "grn", "sparse_grn": "grn", "group_norm": "norm", "layer_norm": "norm"}


def _to_torch_arg(a):
    if isinstance(a, list):
        return [to_ncdhw(v) for v in a]
    if a.dtype == bool:
        return mask_port(a[..., 0])
    return to_ncdhw(a)


def _to_jax_out(t):
    return [_to_jax_out(v) for v in t] if isinstance(t, (list, tuple)) else (
        t.detach().permute(0, 2, 3, 4, 1).numpy())


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name):
    """Output, and the gradients of sum(out * w) for a fixed random w by every
    parameter and by the input, within 1e-5 of their largest entry."""
    jmod, args, tmod, call = _module_case(name)
    rules = _RULES.get(name, name)
    params = numpy_params(jmod, 12, *args)
    jargs = [[jnp.asarray(v) for v in a] if isinstance(a, list) else jnp.asarray(a) for a in args]
    out = jax.jit(jmod.apply)({"params": params}, *jargs)
    outs = out if isinstance(out, (list, tuple)) else [out]
    rs = np.random.RandomState(13)
    ws = [rs.randn(*np.shape(o)).astype(np.float32) for o in outs]

    def loss(p, a0):
        o = jmod.apply({"params": p}, a0, *jargs[1:])
        o = o if isinstance(o, (list, tuple)) else [o]
        return sum(jnp.sum(oi * w) for oi, w in zip(o, ws))

    g_p, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jargs[0])
    tmod.load_state_dict(convert.from_jax(rules, params))
    targs = [_to_torch_arg(a) for a in args]
    x0 = targs[0]
    for t in (x0 if isinstance(x0, list) else [x0]):
        t.requires_grad_(True)
    got = call(tmod, *targs)
    got_l = _to_jax_out(got if isinstance(got, (list, tuple)) else [got])
    for g, w in zip(got_l, outs):
        assert g.shape == np.shape(w)
        assert np.abs(g - np.asarray(w)).max() <= 1e-5 * np.abs(np.asarray(w)).max(), name
    got_t = got if isinstance(got, (list, tuple)) else [got]
    sum((o * torch.from_numpy(w).permute(0, 4, 1, 2, 3)).sum() for o, w in zip(got_t, ws)).backward()
    _close_leaves(_grads_by_name(tmod),
                  {k: v.numpy() for k, v in convert.from_jax(rules, g_p).items()}, 1e-5)
    gx_t = [t.grad for t in (x0 if isinstance(x0, list) else [x0])]
    gx_j = g_x if isinstance(g_x, list) else [g_x]
    for a, b in zip(_to_jax_out(gx_t), gx_j):
        assert np.abs(a - np.asarray(b)).max() <= 1e-5 * np.abs(np.asarray(b)).max(), name


@pytest.mark.parametrize("name", MODULES)
def test_module_decay_mask_and_round_trip(name):
    """no_decay_mask equals JAX's leaf by leaf on the module's tree, and its
    parameters convert to the port and back bit for bit."""
    jmod, args, tmod, _ = _module_case(name)
    rules = _RULES.get(name, name)
    params = numpy_params(jmod, 14, *args)
    flags = jax.tree_util.tree_map(lambda d, p: np.full(np.shape(p), float(d), np.float32),
                                   jax_no_decay_mask(params), params)
    tmod.load_state_dict(convert.from_jax(rules, params))
    assert no_decay_mask(tmod) == {k: bool(v.any())
                                   for k, v in convert.from_jax(rules, flags).items()}
    back = jck.flatten_tree(convert.to_jax(rules, tmod.state_dict()))
    want = jck.flatten_tree(params)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("pool", ["max", "avg", "global"])
def test_masked_pools_match_jax(pool):
    rs = np.random.RandomState(15)
    x = rs.randn(2, 8, 8, 8, 3).astype(np.float32)
    keep = rs.rand(2, 4, 4, 4) > 0.4
    if pool == "global":
        want = jsp.sparse_masked_global_pool(jnp.asarray(x), mask_nd(keep))
        got = tsp.sparse_masked_global_pool(to_ncdhw(x), mask_port(keep))
    else:
        jf, tf = ((jsp.sparse_max_pool, tsp.sparse_max_pool) if pool == "max"
                  else (jsp.sparse_avg_pool, tsp.sparse_avg_pool))
        want = jf(jnp.asarray(x), mask_nd(keep), (2, 2, 2))
        got = tf(to_ncdhw(x), mask_port(keep), (2, 2, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_sparse_batch_norm_matches_jax():
    """SparseBatchNorm (densify norm "bn"): statistics pooled over the
    batch's visible voxels; output and gradients against JAX's module, which
    keeps no running statistics either."""
    rs = np.random.RandomState(16)
    x = (rs.randn(2, 4, 4, 4, 3) + 2.0).astype(np.float32)
    keep = rs.rand(2, 2, 2, 2) > 0.3
    g = rs.randn(2, 4, 4, 4, 3).astype(np.float32)
    params = {"scale": (1 + 0.1 * rs.randn(3)).astype(np.float32),
              "bias": (0.1 * rs.randn(3)).astype(np.float32)}
    jbn = jsp.SparseBatchNorm()

    def jax_fn(p, xx):
        return jnp.sum(jbn.apply({"params": p}, xx, mask_nd(keep)) * g)

    y = jbn.apply({"params": params}, jnp.asarray(x), mask_nd(keep))
    dp, dx = jax.grad(jax_fn, argnums=(0, 1))(params, jnp.asarray(x))
    bn = tsp.SparseBatchNorm(3)
    bn.load_state_dict(convert.from_jax("norm", params))
    xt = to_ncdhw(x).requires_grad_(True)
    got = bn(xt, mask_port(keep))
    (got * to_ncdhw(g)).sum().backward()
    pairs = [(got.detach(), y), (xt.grad, dx), (bn.weight.grad, dp["scale"]),
             (bn.bias.grad, dp["bias"])]
    for t, w in pairs:
        t = t.permute(0, 2, 3, 4, 1) if t.ndim == 5 else t
        w = np.asarray(w)
        assert np.abs(t.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# --- the encoder transfer at STUNet-L and -H depths -----------------------------------

@pytest.mark.parametrize("depth", [2, 3])
def test_encoder_transfer_at_depth_matches_jax(depth, tmp_path):
    """A pretraining checkpoint whose encoder has `depth` blocks a stage (5
    stages, as STUNet-L/H's SparK) into a 6-stage STUNet of that depth
    (STUNetTrainer_large/_huge's): load_ssl_encoder_into_trainer gives JAX's
    network tensor for tensor, from the JAX .npz and from the port's .pt."""
    from anatomask_tpu.models.stunet import STUNet as JaxSTUNet
    from anatomask_tpu.ssl.pretrain import load_ssl_encoder_into_trainer as jax_load
    from anatomask_torch.ssl.pretrain import load_ssl_encoder_into_trainer

    jcfg = JaxPretrainConfig(patch_size=(32, 32, 32), compute_dtype="float32",
                             encoder_dims=(4, 8, 16, 32, 64), encoder_depth=(depth,) * 5)
    jmodel = jax_build_spark_model(jcfg)
    spark = numpy_params(jmodel, 17, jnp.zeros((1, 32, 32, 32, 1)),
                         jmodel.mask(jax.random.PRNGKey(0), 1))
    dims, pools = (4, 8, 16, 32, 64, 64), [(2, 2, 2)] * 4 + [(1, 1, 1)]
    jnet = JaxSTUNet(1, 3, depth=(depth,) * 6, dims=dims, pool_op_kernel_sizes=pools)
    stunet = numpy_params(jnet, 18, jnp.zeros((1, 32, 32, 32, 1)))

    class Holder:  # what both functions read of a trainer
        def __init__(self, params=None, network=None):
            self.params, self.network = params, network

    jck.save_checkpoint(str(tmp_path / "ssl.npz"), {"network_weights": spark})
    want = jax_load(Holder(params=stunet), str(tmp_path / "ssl.npz"), verbose=False).params
    want = convert.stunet_state_dict_from_jax(want)
    sd = convert.from_jax("spark", spark)
    tck.save_trainer_checkpoint(str(tmp_path / "ssl.pt"), {"network_weights": sd}, {})
    for path in ("ssl.npz", "ssl.pt"):
        net = STUNet(1, 3, depth=(depth,) * 6, dims=dims, pool_op_kernel_sizes=pools)
        net.load_state_dict(convert.stunet_state_dict_from_jax(stunet))
        got = load_ssl_encoder_into_trainer(Holder(network=net), str(tmp_path / path),
                                            verbose=False).network.state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
    moved = [k for k in want if k.startswith("conv_blocks_context.") and not k.startswith(
        "conv_blocks_context.5.")]
    assert len({k.split(".")[2] for k in moved}) == depth  # every block of a stage

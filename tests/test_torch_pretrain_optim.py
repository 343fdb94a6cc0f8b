"""The pretraining step's optimizer and accumulation against the JAX package
on the CPU in float32:

- LAMB: three updates of the port's Lamb after the clip against optax's
  chain (clip_by_global_norm(12), then optax.lamb with the no-decay mask, as
  the JAX PretrainTrainer chains it) on the same weights and gradients,
  within 1e-6 of each leaf's largest entry; zero-initialised leaves take
  the trust ratio's 1;
- accumulation: the AnatoMask step at grad_accum_steps=2 against JAX's
  (`_accumulate`'s scan over microbatches, each with its own teacher mask
  and guided mask from split keys) under JAX's draws: the masks bit for
  bit, the loss (rtol 1e-5), the accumulated clipped gradients (within
  7.1e-3 of each leaf's largest entry) and the new student and teacher
  (tests/test_torch_step.py's rule, atol 1e-6);
- the SparK step accumulated over two microbatches equals the one-batch
  step (every norm is per sample), and the microbatch count is lowered
  until it divides the batch, as JAX's trainer lowers it."""
import re
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from anatomask_tpu.ssl.anatomask import generate_guided_mask
from anatomask_tpu.ssl.ema import ema_update
from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_tpu.ssl.pretrain import no_decay_mask as jax_no_decay_mask
from anatomask_tpu.ssl.spark import spark_loss
from anatomask_torch import convert
from anatomask_torch.ssl import pretrain as tp

from torch_parity import numpy_params, to_ncdhw

THREADS = 4
CFG = dict(encoder_dims=(4, 8, 16), patch_size=(32, 32, 32), compute_dtype="float32")


def _models(seed, **kw):
    jcfg = JaxPretrainConfig(**CFG, **kw)
    jmodel = jax_build_spark_model(jcfg)
    params = numpy_params(jmodel, seed, jnp.zeros((1, 32, 32, 32, 1)),
                          jmodel.mask(jax.random.PRNGKey(0), 1))
    return jmodel, params


def _port(params, **kw):
    model = tp.build_spark_model(tp.PretrainConfig(**CFG, **kw), device="cpu")
    model.load_state_dict(convert.from_jax("spark", params))
    return model


def _leaves(tree):
    return {k: v.numpy() for k, v in convert.from_jax("spark", tree).items()}


def test_lamb_matches_optax_chain():
    _, params = _models(1)
    # zero-initialised leaves (the conv biases, as flax initialises them):
    # ||p|| = 0 on the first update, where the trust ratio is 1
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.zeros_like(v) if path[-1].key == "bias" else v, params)
    lr, wd = 1e-2, 1e-2
    chain = optax.chain(optax.clip_by_global_norm(12.0),
                        optax.lamb(lr, weight_decay=wd, mask=jax_no_decay_mask(params)))
    state = chain.init(params)
    model = _port(params)
    optimizer = tp.make_optimizer(model, tp.PretrainConfig(optimizer="lamb", lr=lr,
                                                           weight_decay=wd))
    assert isinstance(optimizer, tp.Lamb)
    rs = np.random.RandomState(2)
    jparams = params
    for step, scale in enumerate((1.0, 40.0, 0.3)):  # the clip acts on the second
        grads = jax.tree_util.tree_map(
            lambda v: (scale * rs.standard_normal(np.shape(v))).astype(np.float32), params)
        if step == 0:  # an update of 0 for a leaf without decay: ratio 1 as well
            grads["mask_token0"] = np.zeros_like(grads["mask_token0"])
        updates, state = chain.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in convert.from_jax("spark", grads).items():
            dict(model.named_parameters())[name].grad = g.clone()
        tp._update(model, optimizer, 1, lr, 12.0)
        want = _leaves(jparams)
        for name, p in model.named_parameters():
            r = want[name]
            assert np.abs(p.detach().numpy() - r).max() <= 1e-6 * np.abs(r).max(), (step, name)


def test_accumulation_steps_follow_jax():
    for batch, req, micro in ((4, 2, 2), (4, 3, 2), (5, 2, 1), (6, 4, 3), (4, 1, 1), (4, 0, 1)):
        assert tp.accumulation_steps(batch, req) == micro


def _jax_accumulated_step(model, params, ema_params, x, key, len_loss, micro):
    """The JAX trainer's anatomask_step with `_accumulate` (micro > 1): keys
    split(rng, micro + 1)[1:], each split into the teacher's mask key and the
    guided mask's; a scan over the microbatches; grads / micro; clip + AdamW;
    EMA. Returns what the test compares and the uniforms of every draw."""
    optimizer = optax.chain(optax.clip_by_global_norm(12.0),
                            optax.adamw(1e-4, weight_decay=1e-5, mask=jax_no_decay_mask(params)))
    keys = jax.random.split(key, micro + 1)[1:]
    mb = x.shape[0] // micro
    L = int(np.prod(model.fmap))

    @jax.jit
    def step(params, ema_params, x):
        def body(acc, inp):
            k, xb = inp
            k1, k2 = jax.random.split(k)
            mask1 = model.mask(k1, mb)
            inp1, rec1 = model.apply({"params": jax.lax.stop_gradient(ema_params)}, xb, mask1)
            _, loss_map = spark_loss(inp1, rec1, mask1)
            hard, _ = generate_guided_mask(k2, loss_map, model.fmap, model.len_keep, len_loss)

            def loss_fn(p):
                i, r = model.apply({"params": p}, xb, hard)
                return spark_loss(i, r, hard)[0]

            loss, g = jax.value_and_grad(loss_fn)(params)
            return jax.tree_util.tree_map(jnp.add, acc, g), (loss, hard)

        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        grads, (losses, hards) = jax.lax.scan(
            body, zeros, (keys, x.reshape(micro, mb, *x.shape[1:])))
        grads = jax.tree_util.tree_map(lambda g: g / micro, grads)
        clipped, _ = optax.clip_by_global_norm(12.0).update(grads, optax.EmptyState())
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        new = optax.apply_updates(params, updates)
        return jnp.mean(losses), hards, clipped, new, ema_update(ema_params, new, 0.999)

    loss, hards, clipped, new, ema = step(params, ema_params, jnp.asarray(x))
    noise = np.zeros((2, x.shape[0], L), np.float32)
    for j, k in enumerate(keys):
        for i, kk in enumerate(jax.random.split(k)):
            noise[i, j * mb:(j + 1) * mb] = np.asarray(jax.random.uniform(kk, (mb, L)))
    return dict(loss=float(loss), hard=np.asarray(hards).reshape(x.shape[0], *model.fmap),
                grads=clipped, params=new, ema=ema, noise=noise)


@pytest.fixture(scope="module")
def accumulated():
    jmodel, params = _models(3)
    _, ema_params = _models(4)
    x = np.random.RandomState(5).rand(4, 32, 32, 32, 1).astype(np.float32)
    L = int(np.prod(jmodel.fmap))
    len_loss = int((L - jmodel.len_keep) * 0.25)
    ref = _jax_accumulated_step(jmodel, params, ema_params, x, jax.random.PRNGKey(6),
                                len_loss, 2)
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        student, teacher = _port(params), tp.make_teacher(_port(ema_params))
        optimizer = tp.make_optimizer(student)
        loss, hard, _ = tp.anatomask_train_step(student, teacher, optimizer, to_ncdhw(x),
                                                len_loss, noise=torch.from_numpy(ref["noise"]),
                                                grad_accum_steps=2)
    finally:
        torch.set_num_threads(saved)
    port_grads = convert.to_jax("spark", {n: p.grad for n, p in student.named_parameters()})
    adamw = optax.adamw(1e-4, weight_decay=1e-5, mask=jax_no_decay_mask(params))
    updates, _ = adamw.update(port_grads, adamw.init(params), params)
    return ref, dict(loss=loss.item(), hard=hard[:, 0].numpy(), student=student,
                     teacher=teacher, law=optax.apply_updates(params, updates))


def test_accumulated_masks_and_loss_match_jax(accumulated):
    ref, got = accumulated
    np.testing.assert_array_equal(got["hard"], ref["hard"])
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)


_CANCELLED = re.compile(r"sparse_encoder\.sp_cnn\.conv_blocks_context\.\d+\.\d+\.conv[12]\.bias")


def test_accumulated_gradients_match_jax(accumulated):
    """Each leaf within 7.1e-3 of its largest entry (test_torch_step.py's
    limit); no activation input of this step lies close enough to a branch
    point to need test_torch_pretrain_configs.py's flip reach."""
    from test_torch_pretrain_configs import _GRAD_RTOL
    ref, got = accumulated
    want = _leaves(ref["grads"])
    named = dict(got["student"].named_parameters())
    g_max = max(np.abs(r).max() for r in want.values())
    for name, r in want.items():
        g = named[name].grad.numpy()
        if _CANCELLED.fullmatch(name):
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-6 * g_max, name
        else:
            assert np.abs(g - r).max() <= _GRAD_RTOL * np.abs(r).max(), name


def test_accumulated_update_and_teacher_match_jax(accumulated):
    """The new student against JAX's, and where Adam is steep (|g| < 100 eps)
    against optax's AdamW on the port's own accumulated gradients, atol 1e-6
    (tests/test_torch_step.py's rule); the new teacher against JAX's."""
    ref, got = accumulated
    grads, want, law = _leaves(ref["grads"]), _leaves(ref["params"]), _leaves(got["law"])
    for name, p in got["student"].named_parameters():
        p, steep = p.detach().numpy(), np.abs(grads[name]) < 100 * 1e-8
        np.testing.assert_allclose(p[~steep], want[name][~steep], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(p[steep], law[name][steep], rtol=0, atol=1e-6, err_msg=name)
    ema = _leaves(ref["ema"])
    for name, p in got["teacher"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ema[name], rtol=0, atol=1e-6, err_msg=name)


def test_spark_step_accumulation_equals_one_batch():
    """Per-sample norms: two microbatches of 2 give the one-batch gradient."""
    _, params = _models(7)
    x = to_ncdhw(np.random.RandomState(8).rand(4, 32, 32, 32, 1).astype(np.float32))
    noise = torch.from_numpy(np.random.RandomState(9).rand(4, 512).astype(np.float32))
    grads, losses = [], []
    for micro in (1, 2):
        model = _port(params)
        cfg = replace(tp.PretrainConfig(), lr=0.0)  # the gradients only
        losses.append(tp.spark_train_step(model, tp.make_optimizer(model, cfg), x, noise=noise,
                                          lr=0.0, grad_accum_steps=micro).item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    g_max = max(g.abs().max().item() for g in grads[0].values())
    for name, g in grads[0].items():
        assert (grads[1][name] - g).abs().max().item() <= 1e-5 * g_max, name
    with pytest.raises(ValueError, match="does not divide"):
        tp.spark_train_step(model, tp.make_optimizer(model), x, noise=noise, grad_accum_steps=3)

"""One full AnatoMask pretraining step of anatomask_torch against the same step
in JAX (the logic of bench.py's step with one microbatch, optax AdamW with
clip 12, EMA 0.999) on the CPU in float32, with shared weights, data and
random draws: the loss, the gradients, the new student and the new teacher.

The encoder has the main path's five stages. The input is 64^3, so that the
bottom level is a 4x4x4 patch grid with 26 visible voxels a sample: at 32^3
it would be 2x2x2 with 3, too few for the masked norms' statistics to hold
round-off to the tolerances below."""
import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from anatomask_tpu.ssl.anatomask import generate_guided_mask
from anatomask_tpu.ssl.ema import ema_update
from anatomask_tpu.ssl.pretrain import no_decay_mask as jax_no_decay_mask
from anatomask_tpu.ssl.spark import spark_loss
from anatomask_tpu.training.checkpoint import convert_torch_spark_state_dict
from anatomask_torch.convert import spark_state_dict_from_jax
from anatomask_torch.ssl.pretrain import (anatomask_train_step, build_spark_model,
                                          clip_by_global_norm_, make_optimizer,
                                          make_teacher, no_decay_mask)

from torch_parity import (BATCH, DIMS, jax_build_spark_model, jax_params, port_model,
                          tiny_configs, to_ncdhw)

STEP_PATCH = (64, 64, 64)


def _jax_step(model, params, ema_params, x, key, len_loss):
    """bench.py's micro_grads + train_step for MICRO = 1, jitted."""
    optimizer = optax.chain(
        optax.clip_by_global_norm(12.0),
        optax.adamw(1e-4, weight_decay=1e-5, mask=jax_no_decay_mask(params)),
    )
    k1, k2 = jax.random.split(key)

    @jax.jit
    def step(params, ema_params, x):
        opt_state = optimizer.init(params)
        mask1 = model.mask(k1, x.shape[0])
        inp1, rec1 = model.apply({"params": jax.lax.stop_gradient(ema_params)}, x, mask1)
        _, loss_map = spark_loss(inp1, rec1, mask1)
        hard, _ = generate_guided_mask(k2, loss_map, model.fmap, model.len_keep, len_loss)

        def loss_fn(p):
            inp, rec = model.apply({"params": p}, x, hard)
            return spark_loss(inp, rec, hard)[0]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        clipped, _ = optax.clip_by_global_norm(12.0).update(grads, optax.EmptyState())
        updates, _ = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        return loss, clipped, new_params, ema_update(ema_params, new_params, 0.999), hard

    loss, clipped, new_params, new_ema, hard = step(params, ema_params, x)
    noise = np.stack([np.asarray(jax.random.uniform(k, (x.shape[0], int(np.prod(model.fmap)))))
                      for k in (k1, k2)])
    return dict(loss=float(loss), grads=clipped, params=new_params, ema=new_ema,
                hard=np.asarray(hard)[..., 0], noise=noise)


# torch's CPU reductions split their sums by the intra-op thread count, so the
# port's gradients move with it; the step runs pinned to this many threads,
# whatever the cores of the process that runs it
STEP_THREADS = 4


def jax_reference():
    """The JAX step and the inputs it took: (ref, params, ema_params, x,
    len_loss)."""
    jcfg, _ = tiny_configs(DIMS, STEP_PATCH)
    jmodel = jax_build_spark_model(jcfg)
    params = jax_params(jmodel, seed=21)
    ema_params = jax_params(jmodel, seed=22)  # a teacher that differs from the student
    x = np.random.RandomState(23).rand(BATCH, *STEP_PATCH, 1).astype(np.float32)
    L = int(np.prod(jmodel.fmap))
    len_loss = max(1, int((L - jmodel.len_keep) * 0.25))
    ref = _jax_step(jmodel, params, ema_params, jnp.asarray(x), jax.random.PRNGKey(24),
                    len_loss)
    return ref, params, ema_params, x, len_loss


def port_step(params, ema_params, x, len_loss, noise, threads=STEP_THREADS):
    """The port's step on the same weights, data and draws, at `threads`
    torch intra-op threads (restored afterwards)."""
    _, tcfg = tiny_configs(DIMS, STEP_PATCH)
    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        student = port_model(params, tcfg)
        teacher = make_teacher(port_model(ema_params, tcfg))
        optimizer = make_optimizer(student)
        loss, hard, _ = anatomask_train_step(student, teacher, optimizer, to_ncdhw(x),
                                             len_loss, noise=torch.from_numpy(noise))
    finally:
        torch.set_num_threads(saved)
    # optax's AdamW applied to the port's own (clipped) gradients: the law the
    # port's optimizer must follow element by element
    port_grads = convert_torch_spark_state_dict(
        {n: p.grad for n, p in student.named_parameters()})
    adamw = optax.adamw(1e-4, weight_decay=1e-5, mask=jax_no_decay_mask(params))
    updates, _ = adamw.update(port_grads, adamw.init(params), params)
    law = optax.apply_updates(params, updates)
    return dict(loss=loss.item(), hard=hard[:, 0].numpy(), student=student,
                teacher=teacher, law=law)


@pytest.fixture(scope="module")
def both_steps():
    ref, params, ema_params, x, len_loss = jax_reference()
    return ref, port_step(params, ema_params, x, len_loss, ref["noise"])


def _pairs(tree, module, attr):
    expect = spark_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    named = dict(module.named_parameters())
    assert set(expect) == set(named)
    for name, ref in expect.items():
        got = getattr(named[name], attr) if attr else named[name]
        yield name, got.detach().numpy(), ref.numpy()


def test_hard_mask_matches(both_steps):
    ref, got = both_steps
    np.testing.assert_array_equal(got["hard"], ref["hard"])


def test_loss_matches(both_steps):
    ref, got = both_steps
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)


# A conv bias right before an instance norm is cancelled by the norm: its exact
# gradient is zero, and both frameworks return round-off there. Those leaves
# must vanish in both (<= 1e-6 of the step's largest gradient). Every other
# leaf agrees to _GRAD_RTOL of its own largest entry: max|g - r| / max|r| of
# the leaves, measured by `python tests/torch_gradient_gaps.py threads` with
# torch pinned to 1, 2, 4 and 8 threads, peaks at 3.4982e-3, 3.4985e-3,
# 3.4987e-3 and 3.4987e-3 against the jitted JAX step (densify_projs.1.weight
# each time; the stem's conv1.weight, the first leaf over the former 1e-3, at
# 1.302e-3-1.308e-3), and at 3.5043e-3, 3.5424e-3, 3.5038e-3 and 3.5040e-3
# against the same step run eagerly (1.289e-3-1.342e-3). The limit is twice
# the largest of them.
_CANCELLED = re.compile(r"sparse_encoder\.sp_cnn\.conv_blocks_context\.\d+\.\d+\.conv[12]\.bias")
_GRAD_RTOL = 7.1e-3


def test_gradients_match(both_steps):
    ref, got = both_steps
    pairs = list(_pairs(ref["grads"], got["student"], "grad"))
    g_max = max(np.abs(r).max() for _, _, r in pairs)
    for name, g, r in pairs:
        if _CANCELLED.fullmatch(name):
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-6 * g_max, name
        else:
            assert np.abs(g - r).max() <= _GRAD_RTOL * np.abs(r).max(), name


# Adam's first step moves a weight by lr * g / (|g| + eps), whose slope at g = 0
# is lr / eps = 1e4: where |g| < 100 * eps (round-off of a cancelled bias, a
# near-zero entry), a 1e-10 difference in g moves the weight by up to 1e-6.
# There the port's new weight is held to optax's law on the port's own
# gradient; everywhere else to the JAX step itself. Both at atol 1e-6.
_ADAM_FLAT = 100 * 1e-8


def test_new_student_matches(both_steps):
    ref, got = both_steps
    grads = {n: r for n, _, r in _pairs(ref["grads"], got["student"], "grad")}
    law = {n: r for n, _, r in _pairs(got["law"], got["student"], None)}
    for name, p, r in _pairs(ref["params"], got["student"], None):
        steep = np.abs(grads[name]) < _ADAM_FLAT
        np.testing.assert_allclose(p[~steep], r[~steep], rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(p[steep], law[name][steep], rtol=0, atol=1e-6,
                                   err_msg=name)


def test_new_teacher_matches(both_steps):
    ref, got = both_steps
    for name, p, r in _pairs(ref["ema"], got["teacher"], None):
        np.testing.assert_allclose(p, r, rtol=0, atol=1e-6, err_msg=name)


def test_no_decay_mask_matches_jax(both_steps):
    ref, got = both_steps
    jmask = jax_no_decay_mask(ref["params"])
    expect = spark_state_dict_from_jax(jax.tree_util.tree_map(
        lambda d: np.full((1,) * 5, float(d)) if d else np.zeros((1,) * 5), jmask))
    port = no_decay_mask(got["student"])
    assert set(port) == set(expect)
    for name, flag in port.items():
        assert flag == bool(expect[name].numpy().any()), name


@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_clip_follows_optax(scale):
    rs = np.random.RandomState(int(scale * 10))
    leaves = [rs.randn(4, 5).astype(np.float32) * scale, rs.randn(7).astype(np.float32)]
    max_norm = 2.0
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(v) for v in leaves], optax.EmptyState())
    grads = [torch.from_numpy(v.copy()) for v in leaves]
    clip_by_global_norm_(grads, max_norm)
    for g, r in zip(grads, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


def test_teacher_is_frozen_copy():
    _, tcfg = tiny_configs(DIMS, STEP_PATCH)
    student = build_spark_model(tcfg, device="cpu")
    teacher = make_teacher(student)
    assert not any(p.requires_grad for p in teacher.parameters())
    for p, q in zip(student.parameters(), teacher.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()

"""Data parallelism on the CPU: one spawn of 2 gloo ranks (2 threads each)
runs every case of tests/torch_ddp_cases.py on its rows of a global batch,
and one process runs them on the whole global batch with the same draws:

- the AnatoMask step of a tiny SparK in fp32 with densify and decoder norm
  "bn" and the batch-pooled norms, global batch 4 in 2 microbatches, 2 steps;
- Trainer.train_step (2 steps) and val_step of ATKTrainerBN (BatchNorm, DC +
  CE) and ATKTrainerTopkLoss (DC + top-k CE), batch Dice, an ignore label;
- DC + top-k (with ties at the threshold) and DC + CE on given logits.

The ranks against one process: losses, gradients, weights and the val
counts within 1e-5 of the largest entry of their kind; the two ranks'
weights, teachers and gradients bit-identical. The pooled SparK's loss under
one mask and both compound losses (value and gradient) against the JAX
package's on the global batch, through tests/torch_parity.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_cases as cases
from anatomask_torch import convert
from anatomask_torch.parallel import mesh
from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_tpu.ssl.spark import spark_loss as jax_spark_loss
from anatomask_tpu.training import losses as jax_losses
from torch_parity import mask_nd, numpy_params

WORLD = 2
TOL = 1e-5  # of the largest entry
# AdamW moves a weight whose gradient is round-off (a conv bias that the next
# norm cancels: below 1e-6 of the largest gradient, 1e-9 measured here) by
# about lr * sign(noise) a step, whatever the noise's size: such weights are
# held to that bound instead
ROUND_OFF = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's pooled SparK loss on the global batch, one process's results,
    the ranks' results); the SparK's weights are JAX's, drawn with numpy."""
    folder = str(tmp_path_factory.mktemp("ddp"))
    jcfg = JaxPretrainConfig(**cases.SPARK)
    jmodel = jax_build_spark_model(jcfg)
    x, _, keep = cases.spark_inputs(jmodel.fmap, jmodel.len_keep)
    keep_nd = keep[:, 0]
    params = numpy_params(jmodel, 8, jnp.zeros((1, *jcfg.patch_size, 1)), mask_nd(keep_nd[:1]))
    torch.save(convert.from_jax("spark", params), os.path.join(folder, "spark_init.pt"))
    inp, rec = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
                                     mask_nd(keep_nd))
    jax_loss = float(jax_spark_loss(inp, rec, mask_nd(keep_nd))[0])

    mesh.launch(cases.run_all, WORLD, "cpu", folder)
    threads = torch.get_num_threads()
    try:
        cases.run_all(folder)
    finally:
        torch.set_num_threads(threads)
    load = lambda n: torch.load(os.path.join(folder, n))  # noqa: E731
    return jax_loss, load("one.pt"), [load(f"rank{r}.pt") for r in range(WORLD)]


def _close(got, want, what):
    """Each tensor of `got` within TOL of the largest entry of all of `want`."""
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        assert float((got[k] - v).abs().max()) <= TOL * scale, (what, k)


def _identical(ranks, key):
    for r in ranks[1:]:
        for k, v in ranks[0][key].items():
            assert torch.equal(r[key][k], v), (key, k)


def test_anatomask_losses_match_one_process(runs):
    _, one, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["anatomask"]["losses"], one["anatomask"]["losses"],
                                   rtol=TOL)


@pytest.mark.parametrize("key", ["grads", "student", "teacher"])
def test_anatomask_state_matches_one_process(runs, key):
    _, one, ranks = runs
    got, want = dict(ranks[0]["anatomask"][key]), dict(one["anatomask"][key])
    grads = one["anatomask"]["grads"]
    g_max = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        if key == "student" and float(g.abs().max()) <= ROUND_OFF * g_max:
            step = float((got.pop(name) - want.pop(name)).abs().max())
            assert step <= 2 * cases.LR * cases.STEPS, name
    _close(got, want, key)


@pytest.mark.parametrize("key", ["grads", "student", "teacher"])
def test_anatomask_state_bit_identical_across_ranks(runs, key):
    _identical([r["anatomask"] for r in runs[2]], key)


def test_pooled_spark_loss_matches_jax_on_the_global_batch(runs):
    jax_loss, one, ranks = runs
    shares = [r["anatomask"]["masked_loss"] for r in ranks]
    np.testing.assert_allclose(np.mean(shares), jax_loss, rtol=TOL)
    np.testing.assert_allclose(one["anatomask"]["masked_loss"], jax_loss, rtol=TOL)


@pytest.mark.parametrize("preset", cases.PRESETS)
def test_trainer_steps_match_one_process(runs, preset):
    _, one, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[preset]["losses"], one[preset]["losses"], rtol=TOL)
    _close(ranks[0][preset]["grads"], one[preset]["grads"], "grads")
    _close(ranks[0][preset]["weights"], one[preset]["weights"], "weights")


@pytest.mark.parametrize("preset", cases.PRESETS)
def test_trainer_state_bit_identical_across_ranks(runs, preset):
    ranks = [r[preset] for r in runs[2]]
    _identical(ranks, "grads")
    _identical(ranks, "weights")


@pytest.mark.parametrize("preset", cases.PRESETS)
def test_val_step_is_the_global_batch(runs, preset):
    """The val step's loss and hard Dice counts are the global batch's on
    every rank: the one process's (counts exactly)."""
    _, one, ranks = runs
    for r in ranks:
        loss, *counts = r[preset]["val"]
        want_loss, *want = one[preset]["val"]
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
        for g, w in zip(counts, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(cases.LOSSES))
def test_compound_loss_matches_jax_on_the_global_batch(runs, name):
    """The mean of the ranks' shares is JAX's loss over the global batch, and
    each rank's gradient over the world size is JAX's on its rows."""
    _, one, ranks = runs
    logits, target = cases.loss_inputs(5)
    fn = {"dc_topk": lambda lg: jax_losses.dc_and_topk_loss(
              lg, jnp.asarray(target), ignore_label=cases.IGNORE, k_percent=60.0),
          "dc_ce": lambda lg: jax_losses.dc_and_ce_loss(
              lg, jnp.asarray(target), ignore_label=cases.IGNORE)}[name]
    want, grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    grad = np.asarray(grad)
    np.testing.assert_allclose(np.mean([r[f"loss_{name}"]["loss"] for r in ranks]), float(want),
                               rtol=TOL)
    np.testing.assert_allclose(one[f"loss_{name}"]["loss"], float(want), rtol=TOL)
    got = np.concatenate([r[f"loss_{name}"]["grad"].numpy() / WORLD for r in ranks])
    assert np.abs(got - grad).max() <= TOL * np.abs(grad).max()

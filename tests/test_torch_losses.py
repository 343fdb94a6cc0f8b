"""anatomask_torch.training.losses against anatomask_tpu.training.losses on the
CPU: every loss and the deep-supervision sum, value and gradient with respect
to the logits within 1e-5 relative, on the same seeded inputs (labels with
and without an ignore label, regions with and without an ignore channel);
the hard Dice counts exactly."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.training import losses as jl
from anatomask_torch.training import losses as pl

B, SPATIAL, K = 2, (6, 5, 7), 3
IGNORE = 3
RTOL = 1e-5


def _logits(seed, k=K):
    return np.random.RandomState(seed).standard_normal((B, *SPATIAL, k)).astype(np.float32) * 2


def _labels(seed, ignore=False):
    rs = np.random.RandomState(seed)
    t = rs.randint(0, K, (B, *SPATIAL)).astype(np.int32)
    if ignore:
        t[rs.rand(*t.shape) < 0.25] = IGNORE
    return t


def _regions(seed, ignore=False):
    rs = np.random.RandomState(seed)
    r = (rs.rand(B, *SPATIAL, K + int(ignore)) < 0.4).astype(np.float32)
    return r


def _check(jax_fn, port_fn, logits, *args):
    """Value and d/dlogits of both within RTOL of the reference's largest."""
    ref, ref_g = jax.value_and_grad(lambda x: jax_fn(x, *map(jnp.asarray, args)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = port_fn(x, *map(torch.from_numpy, args))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    ref_g = np.asarray(ref_g)
    assert np.abs(x.grad.numpy() - ref_g).max() <= RTOL * np.abs(ref_g).max()


@pytest.mark.parametrize("batch_dice", [True, False])
@pytest.mark.parametrize("do_bg", [True, False])
def test_soft_dice_softmax(batch_dice, do_bg):
    _check(lambda x, t: jl.memory_efficient_soft_dice_loss(x, t, batch_dice, do_bg),
           lambda x, t: pl.memory_efficient_soft_dice_loss(x, t, batch_dice, do_bg),
           _logits(0), _labels(1))


@pytest.mark.parametrize("masked", [False, True])
def test_soft_dice_sigmoid_regions(masked):
    mask = (np.random.RandomState(3).rand(B, *SPATIAL, 1) > 0.3).astype(np.float32)
    args = (_regions(2), mask) if masked else (_regions(2),)
    _check(lambda x, t, *m: jl.memory_efficient_soft_dice_loss(
        x, t, do_bg=True, apply_nonlin="sigmoid", loss_mask=m[0] if m else None),
        lambda x, t, *m: pl.memory_efficient_soft_dice_loss(
            x, t, do_bg=True, apply_nonlin="sigmoid", loss_mask=m[0] if m else None),
        _logits(4), *args)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    mask = (np.random.RandomState(6).rand(B, *SPATIAL, 1) > 0.3)
    args = (_labels(5), mask) if masked else (_labels(5),)
    _check(jl.cross_entropy_loss, pl.cross_entropy_loss, _logits(7), *args)


@pytest.mark.parametrize("k_percent", [10.0, 50.0])
def test_topk(k_percent):
    _check(lambda x, t: jl.topk_loss(x, t, k_percent), lambda x, t: pl.topk_loss(x, t, k_percent),
           _logits(8), _labels(9))


@pytest.mark.parametrize("masked", [False, True])
def test_bce(masked):
    mask = (np.random.RandomState(10).rand(B, *SPATIAL, 1) > 0.3).astype(np.float32)
    args = (_regions(11), mask) if masked else (_regions(11),)
    _check(jl.bce_loss, pl.bce_loss, _logits(12), *args)


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("batch_dice", [True, False])
def test_dc_and_ce(ignore, batch_dice):
    label = IGNORE if ignore else None
    _check(lambda x, t: jl.dc_and_ce_loss(x, t, batch_dice=batch_dice, ignore_label=label),
           lambda x, t: pl.dc_and_ce_loss(x, t, batch_dice=batch_dice, ignore_label=label),
           _logits(13), _labels(14, ignore))


@pytest.mark.parametrize("ignore", [False, True])
def test_dc_and_bce_regions(ignore):
    _check(lambda x, t: jl.dc_and_bce_loss(x, t, has_ignore_channel=ignore),
           lambda x, t: pl.dc_and_bce_loss(x, t, has_ignore_channel=ignore),
           _logits(15), _regions(16, ignore))


@pytest.mark.parametrize("ignore", [False, True])
def test_dc_and_topk(ignore):
    label = IGNORE if ignore else None
    _check(lambda x, t: jl.dc_and_topk_loss(x, t, ignore_label=label),
           lambda x, t: pl.dc_and_topk_loss(x, t, ignore_label=label),
           _logits(17), _labels(18, ignore))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_deep_supervision_weights(n):
    np.testing.assert_allclose(pl.deep_supervision_weights(n).numpy(),
                               np.asarray(jl.deep_supervision_weights(n)), rtol=1e-7)


def test_deep_supervision_loss():
    """Three heads at 1, 1/2 and 1/4 resolution (the targets nearest-sampled),
    DC + CE with an ignore label at each: the weighted sum and the gradient
    of each head's logits."""
    shapes = [(4, 6, 8), (2, 3, 4), (1, 2, 2)]
    rs = np.random.RandomState(19)
    outs = [rs.standard_normal((B, *s, K)).astype(np.float32) for s in shapes]
    tgts = [rs.randint(0, K + 1, (B, *s, 1)).astype(np.int32) for s in shapes]

    def jloss(os_):
        return jl.deep_supervision_loss(
            os_, [jnp.asarray(t) for t in tgts],
            lambda o, t: jl.dc_and_ce_loss(o, t[..., 0], ignore_label=IGNORE))

    ref, ref_g = jax.value_and_grad(jloss)([jnp.asarray(o) for o in outs])
    xs = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    got = pl.deep_supervision_loss(
        xs, [torch.from_numpy(t) for t in tgts],
        lambda o, t: pl.dc_and_ce_loss(o, t[..., 0], ignore_label=IGNORE))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    for x, g in zip(xs, ref_g):
        g = np.asarray(g)
        assert np.abs(x.grad.numpy() - g).max() <= RTOL * max(np.abs(g).max(), 1e-30)
    assert not xs[-1].grad.any()  # the lowest resolution's weight is 0


@pytest.mark.parametrize("ignore", [False, True])
def test_hard_dice_parts_labels(ignore):
    logits, t = _logits(20), _labels(21, ignore)
    ref = jl.hard_dice_parts(jnp.asarray(logits), jnp.asarray(t),
                             ignore_label=IGNORE if ignore else None)
    got = pl.hard_dice_parts(torch.from_numpy(logits), torch.from_numpy(t),
                             ignore_label=IGNORE if ignore else None)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("ignore", [False, True])
def test_hard_dice_parts_regions(ignore):
    logits, t = _logits(22), _regions(23, ignore)
    label = 1 if ignore else None  # any value: regions read the last channel
    ref = jl.hard_dice_parts(jnp.asarray(logits), jnp.asarray(t), has_regions=True,
                             ignore_label=label)
    got = pl.hard_dice_parts(torch.from_numpy(logits), torch.from_numpy(t), has_regions=True,
                             ignore_label=label)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_region_targets_match_the_jax_trainer():
    """The trainer's region one-hot (JAX builds it inline with jnp.isin)."""
    seg = np.random.RandomState(24).randint(0, 5, (B, *SPATIAL)).astype(np.int32)
    regions = [(1, 2, 3), (2, 3), 3]
    got = pl.region_targets(torch.from_numpy(seg), regions, ignore_label=4).numpy()
    want = [np.isin(seg, r if isinstance(r, tuple) else (r,)) for r in regions] + [seg == 4]
    np.testing.assert_array_equal(got, np.stack(want, -1).astype(np.float32))

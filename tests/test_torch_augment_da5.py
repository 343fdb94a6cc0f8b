"""anatomask_torch.data.augment_da5 against anatomask_tpu.data.augment_da5 on
the CPU: each DA5 transform given the draws JAX makes from its key (the
keys split as JAX splits them), at p = 1 with the per-channel gate at 0.5,
to 1e-5 of the largest value (the median, Rot90 and TransposeAxes exactly);
then the whole training augmentation with DA5 fed JAX's draws.
ATKTrainerDA5's settings are held to the JAX trainer's in
tests/test_torch_supervised.py::test_unported_options_raise."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.data import augment as jax_aug
from anatomask_tpu.data import augment_da5 as jax_da5
from anatomask_torch.data import augment as aug
from anatomask_torch.data import augment_da5 as da5
from test_torch_augment import _configs, _data_seg, _mixed_key, _t, jax_draws

U, BERN, RANDINT = jax.random.uniform, jax.random.bernoulli, jax.random.randint
ALL_ON = dict(p_rot90=1.0, p_transpose=1.0, p_median_or_blur=1.0, p_additive_brightness=1.0,
              p_contrast=1.0, p_blank_rectangles=1.0, p_brightness_gradient=1.0,
              p_local_gamma=1.0, p_sharpening=1.0)


def _gate(k_apply, k_ch, p, cfg, bc):
    return _t(BERN(k_apply, p, (bc[0], 1, 1, 1, 1)) & BERN(k_ch, cfg.p_per_channel,
                                                           (bc[0], 1, 1, 1, bc[1]))
              ).reshape(bc)


def _bc(a, bc):
    return _t(a).reshape(bc)


def _bump(key, patch, bc):
    sizes = np.array(patch, np.float32)
    k_loc, k_sig = jax.random.split(key)
    loc = U(k_loc, (bc[0], 3, bc[1]), minval=-0.5, maxval=1.5) * sizes[None, :, None]
    log_lo, log_hi = np.log(np.maximum(sizes / 6.0, 1.0)), np.log(sizes)
    sig = jnp.exp(U(k_sig, (bc[0], 3, bc[1])) * (log_hi - log_lo)[None, :, None]
                  + log_lo[None, :, None])
    return _t(loc), _t(sig)


def jax_da5_draws(key, shape, cfg, ic):
    """The port's draw_da5 dict holding what JAX's apply_da5_extras(key, ...)
    draws for data of `shape` (B, *patch, C) under `cfg` (a JAX DA5Config)
    and the intensity config `ic` (its blur)."""
    B, patch, C = shape[0], tuple(shape[1:4]), shape[-1]
    bc = (B, C)
    keys = jax.random.split(key, 9)
    d = {"rot90_on": False, "rot90_k": 0, "rot90_pair": 0, "transpose_on": False,
         "transpose_perm": 0}
    pairs = da5.rot90_pairs(patch)
    if pairs:
        k_apply, k_k, k_pair = jax.random.split(keys[0], 3)
        d.update(rot90_on=bool(BERN(k_apply, cfg.p_rot90)), rot90_k=int(RANDINT(k_k, (), 0, 4)),
                 rot90_pair=int(RANDINT(k_pair, (), 0, len(pairs))))
    perms = da5.transpose_perms(patch)[1]
    if perms:
        k_apply, k_perm = jax.random.split(keys[1])
        d.update(transpose_on=bool(BERN(k_apply, cfg.p_transpose)),
                 transpose_perm=int(RANDINT(k_perm, (), 0, len(perms))))
    k_pick, k_apply, k_ch, k_rounds, k_blur = jax.random.split(keys[2], 5)
    d["median_pick"] = bool(BERN(k_pick, 0.5))
    d["median_on"] = _gate(k_apply, k_ch, cfg.p_median_or_blur, cfg, bc)
    d["median_rounds"] = int(RANDINT(k_rounds, (), 1, 4))
    k1, k2, k3 = jax.random.split(k_blur, 3)
    d["blur_sigma"] = _t(U(k1, bc, minval=ic.blur_sigma[0], maxval=ic.blur_sigma[1]))
    d["blur_on"] = _t(BERN(k2, float(ic.p_blur), (B, 1))
                      & BERN(k3, float(ic.p_blur_per_channel), bc))
    k_apply, k_ch, k_val = jax.random.split(keys[3], 3)
    d["brightness_on"] = _gate(k_apply, k_ch, cfg.p_additive_brightness, cfg, bc)
    d["brightness_shift"] = _bc(jax.random.normal(k_val, (B, 1, 1, 1, C))
                                * cfg.additive_brightness_sigma, bc)
    k_pick, k_apply, k_ch, k_f = jax.random.split(keys[4], 4)
    d["contrast_preserve"] = bool(BERN(k_pick, 0.5))
    d["contrast_on"] = _gate(k_apply, k_ch, cfg.p_contrast, cfg, bc)
    k1, k2, k3 = jax.random.split(k_f, 3)
    lo, hi = cfg.contrast_range
    s5 = (B, 1, 1, 1, C)
    d["contrast_factor"] = _bc(jnp.where(BERN(k1, 0.5, s5), U(k2, s5, minval=lo, maxval=1.0),
                                         U(k3, s5, minval=1.0, maxval=hi)), bc)
    k_apply, k_ch, k_bump, k_str, k_sign = jax.random.split(keys[5], 5)
    d["gradient_on"] = _gate(k_apply, k_ch, cfg.p_brightness_gradient, cfg, bc)
    d["gradient_loc"], d["gradient_sigma"] = _bump(k_bump, patch, bc)
    d["gradient_strength"] = _bc(U(k_str, s5, minval=1.0, maxval=5.0)
                                 * jnp.where(BERN(k_sign, 0.5, s5), 1.0, -1.0), bc)
    k_apply, k_ch, k_bump, k_g, k_pick = jax.random.split(keys[6], 5)
    d["gamma_on"] = _gate(k_apply, k_ch, cfg.p_local_gamma, cfg, bc)
    d["gamma_loc"], d["gamma_sigma"] = _bump(k_bump, patch, bc)
    d["gamma"] = _bc(jnp.where(BERN(k_pick, 0.5, s5),
                               U(jax.random.fold_in(k_g, 0), s5, minval=0.01, maxval=0.8),
                               U(jax.random.fold_in(k_g, 1), s5, minval=1.5, maxval=4.0)), bc)
    sizes = np.array(patch)
    lo_w = np.maximum(1, sizes // 10)
    hi_w = np.maximum(lo_w + 1, sizes // 3)
    k_apply, k_ch, k_n, k_boxes = jax.random.split(keys[7], 4)
    d["rect_on"] = _gate(k_apply, k_ch, cfg.p_blank_rectangles, cfg, bc)
    d["rect_count"] = _t(RANDINT(k_n, (B,), 1, cfg.max_rectangles + 1))
    starts, widths = [], []
    for kb in jax.random.split(k_boxes, cfg.max_rectangles):
        ks, kp = jax.random.split(kb)
        wid = np.stack([np.asarray(RANDINT(jax.random.fold_in(ks, a), (B,), int(lo_w[a]),
                                           int(hi_w[a]))) for a in range(3)], -1)
        start = np.stack([np.asarray(RANDINT(jax.random.fold_in(kp, a), (B,), 0,
                                             max(1, int(sizes[a]) - int(lo_w[a]))))
                          for a in range(3)], -1)
        starts.append(np.minimum(start, sizes[None] - wid))
        widths.append(wid)
    d["rect_start"], d["rect_width"] = _t(np.stack(starts)), _t(np.stack(widths))
    k_apply, k_ch, k_s = jax.random.split(keys[8], 3)
    d["sharpen_on"] = _gate(k_apply, k_ch, cfg.p_sharpening, cfg, bc)
    d["sharpen_strength"] = _bc(U(k_s, s5, minval=0.1, maxval=1.0), bc)
    return d


def _x(seed, shape=(3, 10, 10, 10, 2)):
    return (np.random.RandomState(seed).standard_normal(shape) * 3 + 2).astype(np.float32)


def _key_with(pred, shape, cfg, ic):
    """The first key whose draws satisfy pred."""
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if pred(jax_da5_draws(key, shape, cfg, ic)):
            return key
    raise AssertionError("no key in 100")


TRANSFORMS = ["median", "blur", "brightness", "contrast_preserve", "contrast_stretch",
              "gradient", "local_gamma", "rectangles", "sharpening"]


@pytest.mark.parametrize("name", TRANSFORMS)
def test_da5_transform_matches_jax(name):
    """Each intensity transform of DA5 at p = 1 (p_per_channel 0.5) with
    JAX's draws, on x (3, 10, 10, 10, 2): to 1e-5 of the largest value, the
    median bit for bit."""
    jcfg, cfg = jax_da5.DA5Config(**ALL_ON), da5.DA5Config(**ALL_ON)
    ic = jax_aug.IntensityAugmentConfig(p_blur=1.0)
    x = _x(40)
    shape = x.shape
    pred = {"median": lambda d: d["median_pick"] and d["median_rounds"] > 1,
            "blur": lambda d: not d["median_pick"],
            "contrast_preserve": lambda d: d["contrast_preserve"],
            "contrast_stretch": lambda d: not d["contrast_preserve"]}.get(name, lambda d: True)
    key = _key_with(pred, shape, jcfg, ic)
    d = jax_da5_draws(key, shape, jcfg, ic)
    keys = jax.random.split(key, 9)
    jx, tx = jnp.asarray(x), _t(x)
    ref, got = {
        "median": lambda: (
            jax_da5.median_or_blur(jx, keys[2], jcfg, lambda v, k: jax_aug.gaussian_blur(v, k, ic)),
            da5.median_or_blur(tx, True, d["median_on"], d["median_rounds"], d["blur_sigma"],
                               d["blur_on"])),
        "blur": lambda: (
            jax_da5.median_or_blur(jx, keys[2], jcfg, lambda v, k: jax_aug.gaussian_blur(v, k, ic)),
            da5.median_or_blur(tx, False, d["median_on"], d["median_rounds"], d["blur_sigma"],
                               d["blur_on"])),
        "brightness": lambda: (jax_da5.additive_brightness(jx, keys[3], jcfg),
                               da5.additive_brightness(tx, d["brightness_on"],
                                                       d["brightness_shift"])),
        "contrast_preserve": lambda: (jax_da5.contrast_oneof(jx, keys[4], jcfg),
                                      da5.contrast_oneof(tx, True, d["contrast_on"],
                                                         d["contrast_factor"])),
        "contrast_stretch": lambda: (jax_da5.contrast_oneof(jx, keys[4], jcfg),
                                     da5.contrast_oneof(tx, False, d["contrast_on"],
                                                        d["contrast_factor"])),
        "gradient": lambda: (jax_da5.brightness_gradient_additive(jx, keys[5], jcfg),
                             da5.brightness_gradient_additive(
                                 tx, d["gradient_on"], d["gradient_loc"], d["gradient_sigma"],
                                 d["gradient_strength"])),
        "local_gamma": lambda: (jax_da5.local_gamma(jx, keys[6], jcfg),
                                da5.local_gamma(tx, d["gamma_on"], d["gamma_loc"],
                                                d["gamma_sigma"], d["gamma"])),
        "rectangles": lambda: (jax_da5.blank_rectangles(jx, keys[7], jcfg),
                               da5.blank_rectangles(tx, d["rect_on"], d["rect_count"],
                                                    d["rect_start"], d["rect_width"])),
        "sharpening": lambda: (jax_da5.sharpening(jx, keys[8], jcfg, jax_da5._box_blur3),
                               da5.sharpening(tx, d["sharpen_on"], d["sharpen_strength"])),
    }[name]()
    ref = np.asarray(ref)
    assert not np.array_equal(ref, x)
    if name == "median":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("patch", [(8, 8, 8), (8, 6, 8), (6, 7, 8)])
@pytest.mark.parametrize("name", ["rot90", "transpose"])
def test_da5_axes_transforms_match_jax(name, patch):
    """Rot90 and TransposeAxes on data and seg, exactly, for every draw of
    k, the plane or the permutation (a patch without equal axes passes
    through)."""
    x = _x(41, (2, *patch, 2))
    seg = np.random.RandomState(42).randint(-1, 3, (2, *patch, 2)).astype(np.int16)
    jx, js, tx, ts = jnp.asarray(x), jnp.asarray(seg), _t(x), _t(seg)
    seen = set()
    for seed in range(24):
        key = jax.random.PRNGKey(seed)
        d = jax_da5_draws(jax.random.fold_in(key, 0), x.shape, jax_da5.DA5Config(**ALL_ON),
                          jax_aug.IntensityAugmentConfig())
        keys = jax.random.split(jax.random.fold_in(key, 0), 9)
        if name == "rot90":
            rd, rs = jax_da5.rot90_transform(jx, js, keys[0], patch, 1.0)
            gd, gs = da5.rot90_transform(tx, ts, d["rot90_on"], d["rot90_k"], d["rot90_pair"],
                                         patch)
            seen.add((d["rot90_k"], d["rot90_pair"]))
        else:
            rd, rs = jax_da5.transpose_axes_transform(jx, js, keys[1], patch, 1.0)
            gd, gs = da5.transpose_axes_transform(tx, ts, d["transpose_on"],
                                                  d["transpose_perm"], patch)
            seen.add(d["transpose_perm"])
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    n_options = {"rot90": 4 * len(da5.rot90_pairs(patch)),
                 "transpose": len(da5.transpose_perms(patch)[1])}[name] or 1
    assert len(seen) >= min(n_options, 3)


def test_median3_matches_jax():
    x = _x(43, (2, 7, 6, 9, 3))
    np.testing.assert_array_equal(da5._median3(_t(x)[1, ..., 2]).numpy(),
                                  np.asarray(jax_da5._median3(jnp.asarray(x)))[1, ..., 2])


@pytest.mark.parametrize("p", [1.0, 0.5])
def test_da5_train_augment_matches_jax(p):
    """The whole training pipeline with DA5 (warp with the per-label seg warp,
    noise, low resolution, the gammas, DA5's extras, mirroring, RemoveLabel,
    the pyramid; blur, brightness and contrast only inside DA5) fed JAX's
    draws, DA5's probabilities at p: data to 1e-5 of its largest value, the
    targets bit-equal."""
    da5_kw = {k: p for k in ALL_ON}
    intensity = dict(p_noise=0.5, p_lowres=0.5, lowres_zoom=(0.25, 1.0), p_gamma=0.5,
                     p_gamma_invert=0.5, p_blur=1.0)
    spatial = dict(patch_size=(10, 10, 12), seg_labels=(-1, 0, 1, 2))
    jcfg, _ = _configs(spatial=spatial, intensity=intensity, ds_scales=((1, 1, 1), (2, 2, 2)),
                       da5=jax_da5.DA5Config(**da5_kw))
    _, cfg = _configs(spatial=spatial, intensity=intensity, ds_scales=((1, 1, 1), (2, 2, 2)),
                      da5=da5.DA5Config(**da5_kw))
    data, seg = _data_seg(44)
    key = _mixed_key(jcfg, 4)
    rd, rt = jax_aug.make_train_augment_fn(jcfg)(key, jnp.asarray(data), jnp.asarray(seg))
    draws = jax_draws(key, data.shape, jcfg)
    draws.da5 = jax_da5_draws(jax.random.split(key, 11)[9], (4, 10, 10, 12, data.shape[-1]),
                              jcfg.da5, jcfg.intensity)
    gd, gt = aug.apply_train_augment(cfg, draws, _t(data), _t(seg))
    rd = np.asarray(rd)
    np.testing.assert_allclose(gd.numpy(), rd, rtol=0, atol=1e-5 * np.abs(rd).max())
    assert len(gt) == len(rt) == 2
    for g, r in zip(gt, rt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_draw_da5_shapes_and_ranges():
    """draw_da5 from a CPU generator: every key of JAX's draws, gates (B, C),
    rectangles inside the patch."""
    cfg = da5.DA5Config()
    d = da5.draw_da5(torch.Generator().manual_seed(0), 3, 2, (10, 10, 12), cfg,
                     aug.IntensityAugmentConfig())
    ref = jax_da5_draws(jax.random.PRNGKey(0), (3, 10, 10, 12, 2), jax_da5.DA5Config(),
                        jax_aug.IntensityAugmentConfig())
    assert set(d) == set(ref)
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert d[k].shape == v.shape, k
            assert d[k].dtype.is_floating_point == v.dtype.is_floating_point, k
            assert (d[k].dtype == torch.bool) == (v.dtype == torch.bool), k
        else:
            assert type(d[k]) is type(v), k
    end = d["rect_start"] + d["rect_width"]
    assert (d["rect_start"] >= 0).all() and (end <= torch.tensor((10, 10, 12))).all()
    assert 1 <= d["median_rounds"] <= 3 and 0 <= d["rot90_pair"] < 1


def test_make_train_augment_fn_runs_da5():
    """make_train_augment_fn with DA5 = draw_all (DA5's draws last), then
    apply_train_augment."""
    _, cfg = _configs(spatial=dict(patch_size=(8, 8, 8), seg_labels=(-1, 0, 1, 2)),
                      intensity=dict(p_noise=0.1, p_lowres=0.15, p_gamma=0.1, p_gamma_invert=0.1),
                      da5=da5.DA5Config(**ALL_ON))
    data, seg = (_t(a) for a in _data_seg(45))
    got_d, got_t = aug.make_train_augment_fn(cfg)(torch.Generator().manual_seed(3), data, seg)
    draws = aug.draw_all(torch.Generator().manual_seed(3), data, cfg)
    assert draws.da5 is not None
    want_d, want_t = aug.apply_train_augment(cfg, draws, data, seg)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)
    assert got_d.shape == (4, 8, 8, 8, 2) and torch.isfinite(got_d).all()
    for g, w in zip(got_t, want_t):
        assert torch.equal(g, w)

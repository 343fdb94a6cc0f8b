"""anatomask_torch.data.augment against anatomask_tpu.data.augment on the CPU,
every transform given the draws JAX makes (its keys split as JAX splits
them): the enlarged-patch arithmetic exactly; the spatial warp of the data
(orders 1, 0 and 3, with and without the elastic field) to 1e-5 and of the
seg (per label, or nearest) exactly; each intensity transform; mirroring,
the deep-supervision pyramid and the validation transform exactly; and the
whole training pipeline for each part that was ported with the supervised
path. The DA5 stack still raises."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.data import augment as jax_aug
from anatomask_torch.data import augment as aug


@pytest.mark.parametrize("patch", [(112, 112, 128), (16, 16, 16), (20, 128, 128),
                                   (1, 64, 80), (64, 80), (40, 160)])
def test_initial_patch_size_matches_jax(patch):
    rot, dummy, initial, mirror_axes = aug.rotation_ranges_and_initial_patch_size(patch)
    j_rot, j_dummy, j_initial, j_mirror = jax_aug.rotation_ranges_and_initial_patch_size(patch)
    assert rot == j_rot and dummy == j_dummy and mirror_axes == j_mirror
    np.testing.assert_array_equal(initial, j_initial)
    if patch == (112, 112, 128):
        assert tuple(initial) == (189, 179, 196)


def _mixed_draw(jcfg, batch):
    """A key whose draw mixes warped and identity samples."""
    for seed in range(50):
        key = jax.random.PRNGKey(seed)
        A, ident = jax_aug._affine_matrices(key, batch, jcfg)
        ident = np.array(ident)
        if ident.any() and not ident.all():
            return key, np.array(A), ident
    raise AssertionError("no mixed draw in 50 keys")


@pytest.mark.parametrize("dummy_2d", [False, True])
def test_spatial_augment_matches_jax(dummy_2d):
    """in - out = (7, 7, 8): two axes take the identity crop's 2-tap average."""
    patch, batch = (10, 9, 12), 6
    kw = dict(patch_size=patch, p_rotation=0.5, p_scaling=0.5, dummy_2d=dummy_2d)
    jcfg = jax_aug.SpatialAugmentConfig(**kw)
    cfg = aug.SpatialAugmentConfig(**kw)
    x = np.random.RandomState(0).randn(batch, 17, 16, 20, 2).astype(np.float32)
    key, A, ident = _mixed_draw(jcfg, batch)
    ref, _ = jax_aug.spatial_augment(jnp.asarray(x), None, key, jcfg)
    got = aug.spatial_augment(torch.from_numpy(x), torch.from_numpy(A),
                              torch.from_numpy(ident), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch, *patch, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # the identity samples are the crop, bit for bit
    np.testing.assert_array_equal(got.numpy()[ident], np.asarray(ref)[ident])


def test_mirror_matches_jax():
    x = np.random.RandomState(1).randn(8, 5, 6, 7, 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref, _ = jax_aug.mirror(jnp.asarray(x), None, key, (0, 1, 2))
    flags = np.array(jax.random.bernoulli(key, 0.5, (8, 3)))
    assert flags.any() and not flags.all()
    got = aug.mirror(torch.from_numpy(x), torch.from_numpy(flags), (0, 1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_train_augment_fn_is_warp_then_mirror():
    """make_train_augment_fn draws (A, ident, mirror flags) from the generator
    and applies spatial_augment, then mirror, with them."""
    cfg = aug.AugmentConfig(
        spatial=aug.SpatialAugmentConfig(patch_size=(8, 8, 8), p_rotation=0.5, p_scaling=0.5),
        intensity=aug.IntensityAugmentConfig(p_noise=0, p_blur=0, p_brightness=0,
                                             p_contrast=0, p_lowres=0, p_gamma=0,
                                             p_gamma_invert=0))
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 13, 12, 11, 1).astype(np.float32))
    got, seg = aug.make_train_augment_fn(cfg)(torch.Generator().manual_seed(5), x)
    A, ident, flags = aug.draw_augment_params(torch.Generator().manual_seed(5), 4, cfg)
    want = aug.mirror(aug.spatial_augment(x, A, ident, cfg.spatial), flags, cfg.mirror_axes)
    assert seg is None
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _configs(spatial=None, intensity=None, **kw):
    """The same AugmentConfig in both packages."""
    spatial = dict(dict(patch_size=(10, 9, 12), p_rotation=0.5, p_scaling=0.5), **(spatial or {}))
    intensity = intensity or dict(p_noise=0, p_blur=0, p_brightness=0, p_contrast=0,
                                  p_lowres=0, p_gamma=0, p_gamma_invert=0)
    kw = dict(dict(mirror_axes=(0, 1, 2)), **kw)
    return (jax_aug.AugmentConfig(spatial=jax_aug.SpatialAugmentConfig(**spatial),
                                  intensity=jax_aug.IntensityAugmentConfig(**intensity), **kw),
            aug.AugmentConfig(spatial=aug.SpatialAugmentConfig(**spatial),
                              intensity=aug.IntensityAugmentConfig(**intensity), **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_elastic(key, batch, cfg):
    """spatial_augment's elastic draws from its key."""
    kd, km, kp = jax.random.split(jax.random.fold_in(key, 7), 3)
    g = cfg.elastic_grid
    coarse = jax.random.normal(kd, (batch, g, g, g, 3))
    mag = jax.random.uniform(km, (batch, 1, 1, 1, 1), minval=cfg.elastic_magnitude[0],
                             maxval=cfg.elastic_magnitude[1])
    on = jax.random.bernoulli(kp, float(cfg.p_elastic), (batch, 1, 1, 1, 1))
    return _t(coarse), _t(mag).reshape(batch), _t(on).reshape(batch)


def _jax_intensity(keys, shape, ic):
    """Every intensity transform's draws from make_train_augment_fn's keys
    1-7, and the noise field."""
    b, c = shape[0], shape[-1]
    u, bern = jax.random.uniform, jax.random.bernoulli
    k1, k2, k3 = jax.random.split(keys[1], 3)
    p = {"noise_std": u(k1, (b,), minval=ic.noise_variance[0], maxval=ic.noise_variance[1]),
         "noise_on": bern(k3, float(ic.p_noise), (b,))}
    noise = jax.random.normal(k2, shape)
    k1, k2, k3 = jax.random.split(keys[2], 3)
    p["blur_sigma"] = u(k1, (b, c), minval=ic.blur_sigma[0], maxval=ic.blur_sigma[1])
    p["blur_on"] = bern(k2, float(ic.p_blur), (b, 1)) & bern(k3, float(ic.p_blur_per_channel),
                                                             (b, c))
    k1, k2 = jax.random.split(keys[3])
    p["brightness"] = u(k1, (b, c), minval=ic.brightness_range[0], maxval=ic.brightness_range[1])
    p["brightness_on"] = bern(k2, float(ic.p_brightness), (b,))
    k1, k2, k3 = jax.random.split(keys[4], 3)
    lo, hi = ic.contrast_range
    f_lo = u(k1, (b, c), minval=lo, maxval=min(1.0, hi))
    f_hi = u(k3, (b, c), minval=max(lo, 1.0), maxval=hi)
    pick = bern(jax.random.fold_in(k1, 1), 0.5, (b, c))
    p["contrast"] = jnp.where(pick & (lo < 1.0), f_lo, f_hi)
    p["contrast_on"] = bern(k2, float(ic.p_contrast), (b,))
    k1, k2, k3 = jax.random.split(keys[5], 3)
    p["lowres_zoom"] = u(k1, (b, c), minval=ic.lowres_zoom[0], maxval=ic.lowres_zoom[1])
    p["lowres_on"] = bern(k2, float(ic.p_lowres), (b, 1)) & bern(
        k3, float(ic.p_lowres_per_channel), (b, c))
    for name, key, prob in (("gamma_invert", keys[6], ic.p_gamma_invert),
                            ("gamma", keys[7], ic.p_gamma)):
        k1, k2, k3 = jax.random.split(key, 3)
        uu = u(k2, (b, c))
        p[name] = jnp.where(bern(k1, 0.5, (b, c)), ic.gamma_range[0] + uu * (1 - ic.gamma_range[0]),
                            1 + uu * (ic.gamma_range[1] - 1))
        p[f"{name}_on"] = bern(k3, float(prob), (b,))
    return {k: _t(v) for k, v in p.items()}, _t(noise)


def jax_draws(key, data_shape, jcfg):
    """The port's AugmentDraws holding what make_train_augment_fn(jcfg) draws
    from `key` for a batch of data_shape (B, ix, iy, iz, C)."""
    keys = jax.random.split(key, 11)
    batch = data_shape[0]
    A, ident = jax_aug._affine_matrices(keys[0], batch, jcfg.spatial)
    flags = jax.random.bernoulli(keys[8], 0.5, (batch, len(jcfg.mirror_axes)))
    draws = aug.AugmentDraws(_t(A), _t(ident), _t(flags))
    if jcfg.spatial.p_elastic > 0:
        draws.elastic = _jax_elastic(keys[0], batch, jcfg.spatial)
    draws.intensity, draws.noise = _jax_intensity(
        keys, (batch, *jcfg.spatial.patch_size, data_shape[-1]), jcfg.intensity)
    return draws


def _data_seg(seed, batch=4, shape=(17, 16, 20), channels=2, labels=(0, 1, 2)):
    rs = np.random.RandomState(seed)
    data = (rs.standard_normal((batch, *shape, channels)) * 2 + 1).astype(np.float32)
    # blocky labels (so that warps cross label borders), -1 at one face
    coarse = rs.choice(labels, (batch, 4, 4, 4, 1))
    seg = coarse.repeat(5, 1).repeat(4, 2).repeat(5, 3)[:, :shape[0], :shape[1], :shape[2]]
    seg = seg.astype(np.int16)
    seg[:, :2] = -1
    return data, seg


def _mixed_key(jcfg, batch):
    return _mixed_draw(jcfg.spatial, batch)[0]


TIE_EPS = 1e-4  # the warped data's tolerance


def _tie_gap(key, jcfg, seg, mirror_key=None):
    """Per voxel of the reference's order-1 per-label seg warp, the distance
    of the nearest label's warped indicator to the 0.5 threshold. Each
    indicator (out-of-bounds corners -1, as _seg_per_label_sample) is warped
    by JAX's data path as indicator + 1 (cval 0), then mirrored as the
    pipeline mirrors; shape (B, *patch, 1)."""
    labels = sorted(jcfg.spatial.seg_labels)
    ind = np.concatenate([seg == label for label in labels], -1).astype(np.float32) + 1
    warped, _ = jax_aug.spatial_augment(jnp.asarray(ind), None, key, jcfg.spatial)
    if mirror_key is not None:
        warped, _ = jax_aug.mirror(warped, None, mirror_key, jcfg.mirror_axes)
    return np.abs(np.asarray(warped) - 1.5).min(-1, keepdims=True)


def _assert_equal_but_at_ties(got, ref, gap):
    """got == ref wherever no label's warped indicator lies within TIE_EPS of
    0.5 in the reference."""
    differ = got != ref
    assert (gap[differ] < TIE_EPS).all(), np.sort(gap[differ])[-5:]


@pytest.mark.parametrize("order", [1, 0])
def test_seg_warp_matches_jax(order):
    """Order 1: each label's indicator warped linearly and thresholded at 0.5
    (identity samples as crops); order 0 (DAOrd0): nearest, -1 outside."""
    kw = (dict(seg_labels=(-1, 0, 1, 2)) if order == 1
          else dict(data_interpolation_order0=True))
    jcfg, cfg = _configs(spatial=kw)
    data, seg = _data_seg(30)
    key = _mixed_key(jcfg, 4)
    ref_d, ref_s = jax_aug.spatial_augment(jnp.asarray(data), jnp.asarray(seg), key, jcfg.spatial)
    A, ident = jax_aug._affine_matrices(key, 4, jcfg.spatial)
    got_d, got_s = aug.spatial_augment(_t(data), _t(A), _t(ident), cfg.spatial, seg=_t(seg))
    assert got_s.dtype == torch.int16 and tuple(got_s.shape) == (4, 10, 9, 12, 1)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-5)
    assert len(np.unique(got_s.numpy())) >= 3


def test_cubic_warp_matches_jax():
    """Order 3: the B-spline prefilter and the 4x4x4 sampling, identity
    samples warped too."""
    jcfg, cfg = _configs(spatial=dict(data_interpolation_order=3))
    data, _ = _data_seg(31)
    key = _mixed_key(jcfg, 4)
    ref, _ = jax_aug.spatial_augment(jnp.asarray(data), None, key, jcfg.spatial)
    A, ident = jax_aug._affine_matrices(key, 4, jcfg.spatial)
    got = aug.spatial_augment(_t(data), _t(A), _t(ident), cfg.spatial)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_elastic_field_matches_jax():
    """The displacement (the coarse grid resized linearly) added to the affine
    coordinates: data to 1e-4, the per-label seg bit-equal but at
    threshold ties."""
    jcfg, cfg = _configs(spatial=dict(p_elastic=0.5, seg_labels=(-1, 0, 1, 2)))
    data, seg = _data_seg(32)
    for seed in range(50):
        key = jax.random.PRNGKey(seed)
        elastic = _jax_elastic(key, 4, jcfg.spatial)
        if elastic[2].any() and not elastic[2].all():
            break
    ref_d, ref_s = jax_aug.spatial_augment(jnp.asarray(data), jnp.asarray(seg), key, jcfg.spatial)
    A, ident = jax_aug._affine_matrices(key, 4, jcfg.spatial)
    disp = aug.elastic_displacement(*elastic, cfg.spatial.patch_size, torch.device("cpu"))
    got_d, got_s = aug.spatial_augment(_t(data), _t(A), _t(ident), cfg.spatial, seg=_t(seg),
                                       disp=disp)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(ref_d), rtol=0, atol=1e-4)
    _assert_equal_but_at_ties(got_s.numpy(), np.asarray(ref_s), _tie_gap(key, jcfg, seg))


INTENSITY_ON = dict(p_noise=1.0, p_blur=1.0, p_brightness=1.0, p_contrast=1.0, p_lowres=1.0,
                    p_gamma=1.0, p_gamma_invert=1.0)


@pytest.mark.parametrize("name", ["noise", "blur", "brightness", "contrast", "lowres",
                                  "lowres_axis0", "gamma_invert", "gamma"])
def test_intensity_transform_matches_jax(name):
    """Each transform with JAX's draws at p = 1 (the blur and low resolution
    per channel at 0.5) on x (3, 12, 10, 14, 2)."""
    ic_kw = dict(INTENSITY_ON, lowres_ignore_axis0=name == "lowres_axis0")
    jic, ic = jax_aug.IntensityAugmentConfig(**ic_kw), aug.IntensityAugmentConfig(**ic_kw)
    x = (np.random.RandomState(33).standard_normal((3, 12, 10, 14, 2)) * 3 + 2).astype(np.float32)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, 11)
    p, noise = _jax_intensity(keys, x.shape, jic)
    jx, tx = jnp.asarray(x), _t(x)
    ref, got = {
        "noise": lambda: (jax_aug.gaussian_noise(jx, keys[1], jic),
                          aug.gaussian_noise(tx, p["noise_std"], p["noise_on"], noise)),
        "blur": lambda: (jax_aug.gaussian_blur(jx, keys[2], jic),
                         aug.gaussian_blur(tx, p["blur_sigma"], p["blur_on"])),
        "brightness": lambda: (jax_aug.brightness_multiplicative(jx, keys[3], jic),
                               aug.brightness_multiplicative(tx, p["brightness"],
                                                             p["brightness_on"])),
        "contrast": lambda: (jax_aug.contrast(jx, keys[4], jic),
                             aug.contrast(tx, p["contrast"], p["contrast_on"])),
        "lowres": lambda: (jax_aug.simulate_lowres(jx, keys[5], jic),
                           aug.simulate_lowres(tx, p["lowres_zoom"], p["lowres_on"], False)),
        "lowres_axis0": lambda: (jax_aug.simulate_lowres(jx, keys[5], jic),
                                 aug.simulate_lowres(tx, p["lowres_zoom"], p["lowres_on"], True)),
        "gamma_invert": lambda: (jax_aug._gamma_once(jx, keys[6], 1.0, True, jic),
                                 aug.gamma_transform(tx, p["gamma_invert"], p["gamma_invert_on"],
                                                     True)),
        "gamma": lambda: (jax_aug._gamma_once(jx, keys[7], 1.0, False, jic),
                          aug.gamma_transform(tx, p["gamma"], p["gamma_on"], False)),
    }[name]()
    ref = np.asarray(ref)
    assert not np.array_equal(ref, x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_mirror_with_seg_matches_jax():
    data, seg = _data_seg(34)
    key = jax.random.PRNGKey(4)
    ref_d, ref_s = jax_aug.mirror(jnp.asarray(data), jnp.asarray(seg), key, (0, 1, 2))
    flags = _t(jax.random.bernoulli(key, 0.5, (4, 3)))
    np.testing.assert_array_equal(aug.mirror(_t(seg), flags, (0, 1, 2)).numpy(),
                                  np.asarray(ref_s))
    np.testing.assert_array_equal(aug.mirror(_t(data), flags, (0, 1, 2)).numpy(),
                                  np.asarray(ref_d))


@pytest.mark.parametrize("scales", [((1, 1, 1), (2, 2, 2), (4, 4, 4)),
                                    ((1, 1, 1), (1, 2, 2), (2, 4, 4)),
                                    ((1, 1, 1), (2, 2, 1), (3, 3, 1))])
def test_downsample_seg_for_ds_matches_jax(scales):
    _, seg = _data_seg(35, shape=(16, 12, 20))
    ref = jax_aug.downsample_seg_for_ds(jnp.asarray(seg), scales)
    got = aug.downsample_seg_for_ds(_t(seg), scales)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("cascade", [False, True])
def test_val_transform_matches_jax(cascade):
    """RemoveLabel, the pyramid and (cascade) seg channel 1 one-hot into the data."""
    kw = dict(ds_scales=((1, 1, 1), (2, 2, 2)),
              cascade_foreground_labels=(1, 2) if cascade else ())
    jcfg, cfg = _configs(**kw)
    data, seg = _data_seg(36, shape=(10, 8, 12))
    if cascade:
        seg = np.concatenate([seg, np.roll(seg, 3, 1)], -1)
    rd, rt = jax_aug.make_val_transform_fn(jcfg)(jax.random.PRNGKey(0), jnp.asarray(data),
                                                 jnp.asarray(seg))
    gd, gt = aug.make_val_transform_fn(cfg)(None, _t(data), _t(seg))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    for g, r in zip(gt, rt):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("part", ["intensity", "elastic", "order3", "order0", "seg_labels"])
def test_ported_part_matches_jax(part):
    """The whole training pipeline (warp, intensity, mirror, mask-for-norm,
    RemoveLabel, the pyramid) with the part switched on that the pretraining
    slice left out, fed JAX's draws: data to 1e-4 of its largest value, the
    targets bit-equal but at per-label threshold ties."""
    spatial = {"intensity": dict(seg_labels=(-1, 0, 1, 2)),
               "elastic": dict(p_elastic=0.5, seg_labels=(-1, 0, 1, 2)),
               "order3": dict(data_interpolation_order=3, seg_labels=(-1, 0, 1, 2)),
               "order0": dict(data_interpolation_order0=True),
               "seg_labels": dict(seg_labels=(-1, 0, 1, 2))}[part]
    intensity = dict(INTENSITY_ON, p_noise=0.5, p_contrast=0.5) if part == "intensity" else None
    jcfg, cfg = _configs(spatial=spatial, intensity=intensity, mask_channels_for_norm=(0,),
                         ds_scales=((1, 1, 1), (2, 2, 2)))
    data, seg = _data_seg(37)
    key = _mixed_key(jcfg, 4)
    rd, rt = jax_aug.make_train_augment_fn(jcfg)(key, jnp.asarray(data), jnp.asarray(seg))
    gd, gt = aug.apply_train_augment(cfg, jax_draws(key, data.shape, jcfg), _t(data), _t(seg))
    rd = np.asarray(rd)
    np.testing.assert_allclose(gd.numpy(), rd, rtol=0, atol=1e-4 * np.abs(rd).max())
    assert len(gt) == len(rt) == 2
    if part == "elastic":
        keys = jax.random.split(key, 11)
        gap = jnp.asarray(_tie_gap(keys[0], jcfg, seg, mirror_key=keys[8]))
        gaps = [np.asarray(g) for g in jax_aug.downsample_seg_for_ds(gap, jcfg.ds_scales)]
    for i, (g, r) in enumerate(zip(gt, rt)):
        assert g.dtype == torch.int16
        if part == "elastic":
            _assert_equal_but_at_ties(g.numpy(), np.asarray(r), gaps[i])
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_train_augment_fn_draws_then_applies():
    """make_train_augment_fn = draw_all from the generator, then
    apply_train_augment with those draws, on a batch with seg."""
    _, cfg = _configs(spatial=dict(seg_labels=(-1, 0, 1, 2)),
                      intensity=dict(INTENSITY_ON, p_noise=0.5), ds_scales=((1, 1, 1), (2, 2, 2)))
    data, seg = (_t(a) for a in _data_seg(38))
    got_d, got_t = aug.make_train_augment_fn(cfg)(torch.Generator().manual_seed(3), data, seg)
    draws = aug.draw_all(torch.Generator().manual_seed(3), data, cfg)
    want_d, want_t = aug.apply_train_augment(cfg, draws, data, seg)
    torch.testing.assert_close(got_d, want_d, rtol=0, atol=0)
    for g, w in zip(got_t, want_t):
        assert torch.equal(g, w)

"""anatomask_torch.data.augment against anatomask_tpu.data.augment on the CPU:
the enlarged-patch arithmetic exactly, the spatial warp (given the matrices and
identity flags that JAX's `_affine_matrices` draws) to 1e-5 in fp32, and the
mirroring (given the same flags) exactly."""
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


@pytest.mark.parametrize("change", [
    dict(intensity=aug.IntensityAugmentConfig()),
    dict(spatial=aug.SpatialAugmentConfig(patch_size=(8, 8, 8), p_elastic=0.2)),
    dict(spatial=aug.SpatialAugmentConfig(patch_size=(8, 8, 8), data_interpolation_order=3)),
    dict(spatial=aug.SpatialAugmentConfig(patch_size=(8, 8, 8), data_interpolation_order0=True)),
    dict(spatial=aug.SpatialAugmentConfig(patch_size=(8, 8, 8), seg_labels=(1, 2))),
])
def test_unported_parts_raise(change):
    off = aug.IntensityAugmentConfig(p_noise=0, p_blur=0, p_brightness=0, p_contrast=0,
                                     p_lowres=0, p_gamma=0, p_gamma_invert=0)
    kw = dict(spatial=aug.SpatialAugmentConfig(patch_size=(8, 8, 8)), intensity=off)
    kw.update(change)
    with pytest.raises(NotImplementedError):
        aug.make_train_augment_fn(aug.AugmentConfig(**kw))

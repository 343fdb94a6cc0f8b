"""The port's data path and host helpers against the JAX package's, on the
CPU: the case store and npz -> npy unpacking, the patch sampler and the
device case cache (same seed -> same boxes, bit-equal patches), the LR
schedules, the cross-validation split and the dataset-name lookup."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.data.dataset import CaseDataset as JaxCaseDataset
from anatomask_tpu.data.dataset import unpack_dataset as jax_unpack
from anatomask_tpu.data.device_cache import DeviceCaseCache as JaxDeviceCaseCache
from anatomask_tpu.data.sampler import PatchSampler as JaxPatchSampler
from anatomask_tpu.preprocessing.preprocessor import save_properties
from anatomask_tpu.training import schedules as jax_schedules
from anatomask_tpu.training.trainer import generate_crossval_split as jax_split
from anatomask_torch.data.dataset import CaseDataset, unpack_dataset
from anatomask_torch.data.device_cache import DeviceCaseCache
from anatomask_torch.data.sampler import PatchSampler
from anatomask_torch.preprocessing.preprocessor import load_properties
from anatomask_torch.training import schedules
from anatomask_torch.training.trainer import generate_crossval_split
from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name

# case shapes: two smaller than the initial patch on some axis (padding), one larger
SHAPES = [(18, 20, 16), (26, 24, 30), (12, 28, 22), (30, 30, 30)]
INITIAL, FINAL = (21, 19, 23), (16, 16, 16)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Preprocessed cases as the JAX preprocessor writes them: <key>.npz with
    data (1, x, y, z) float32 and seg (1, x, y, z), and the properties with
    class_locations in (0, x, y, z) coordinates."""
    d = str(tmp_path_factory.mktemp("cases"))
    rs = np.random.RandomState(0)
    for i, shape in enumerate(SHAPES):
        data = rs.randn(1, *shape).astype(np.float32)
        seg = np.zeros((1, *shape), np.int8)
        c = [s // 2 for s in shape]
        seg[0, c[0] - 3:c[0] + 3, c[1] - 2:c[1] + 4, c[2] - 3:c[2] + 2] = 1
        seg[0, :3, :3, :3] = 2
        np.savez(os.path.join(d, f"case_{i:03d}.npz"), data=data, seg=seg)
        locs = {lab: np.argwhere(seg == lab) for lab in (1, 2)}
        save_properties({"spacing": [1.0, 1.0, 1.0], "class_locations": locs},
                        os.path.join(d, f"case_{i:03d}"))
    return d


def test_unpack_and_case_dataset_match_jax(folder):
    unpack_dataset(folder, num_processes=1)
    names = sorted(os.listdir(folder))
    assert sum(n.endswith("_seg.npy") for n in names) == len(SHAPES)
    jax_unpack(folder, num_processes=1)  # finds the npy files, writes nothing
    assert sorted(os.listdir(folder)) == names
    ds, jds = CaseDataset(folder), JaxCaseDataset(folder)
    assert list(ds.keys()) == list(jds.keys())
    for k in ds.keys():
        (d, s, p), (jd, js, jp) = ds.load_case(k), jds.load_case(k)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(s, js)
        assert ds.case_shape(k) == jds.case_shape(k) == d.shape
        assert p["class_locations"].keys() == jp["class_locations"].keys()
        for lab in p["class_locations"]:
            np.testing.assert_array_equal(p["class_locations"][lab], jp["class_locations"][lab])
        assert load_properties(os.path.join(folder, k))["spacing"] == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("load_seg", [False, True])
def test_patch_sampler_matches_jax(folder, load_seg):
    kw = dict(batch_size=3, patch_size=INITIAL, final_patch_size=FINAL,
              oversample_foreground_percent=0.33, annotated_classes_key=(1, 2), seed=7,
              load_seg=load_seg)
    ours = PatchSampler(CaseDataset(folder), **kw)
    theirs = JaxPatchSampler(JaxCaseDataset(folder), **kw)
    for _ in range(4):
        a, b = ours.generate_batch(), theirs.generate_batch()
        assert a["keys"] == b["keys"]
        assert a.keys() == b.keys()
        for k in ("data", "seg") if load_seg else ("data",):
            np.testing.assert_array_equal(a[k], b[k])


def test_probabilistic_oversampling_matches_jax(folder):
    """A per-sample foreground draw in place of the batch's tail: the same
    boxes, data and seg from one seed."""
    kw = dict(batch_size=3, patch_size=INITIAL, final_patch_size=FINAL,
              oversample_foreground_percent=0.5, annotated_classes_key=(1, 2), seed=8,
              probabilistic_oversampling=True)
    ours = PatchSampler(CaseDataset(folder), **kw)
    theirs = JaxPatchSampler(JaxCaseDataset(folder), **kw)
    for _ in range(4):
        a, b = ours.generate_batch(), theirs.generate_batch()
        assert a["keys"] == b["keys"]
        for k in ("data", "seg"):
            np.testing.assert_array_equal(a[k], b[k])


def _caches(folder, **kw):
    kw = dict(initial_patch=INITIAL, final_patch=FINAL, oversample_foreground_percent=0.33,
              annotated_classes_key=(1, 2), batch_size=3, seed=11, **kw)
    return (DeviceCaseCache(CaseDataset(folder), dtype=torch.bfloat16, device="cpu", **kw),
            JaxDeviceCaseCache(JaxCaseDataset(folder), dtype=jnp.bfloat16, **kw))


def _as_f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("whole", [True, False])
def test_device_cache_matches_jax(folder, whole):
    ours, theirs = _caches(folder, whole_dataset_mode=whole, capacity_mb=64 if whole else 1)
    assert ours.whole_dataset_resident == theirs.whole_dataset_resident == whole
    assert (ours.num_slots, ours.slot_shape) == (theirs.num_slots, theirs.slot_shape)
    assert [m.key for m in ours.meta] == [m.key for m in theirs.meta]
    np.testing.assert_array_equal(_as_f32(ours.cache), _as_f32(theirs.cache))
    for _ in range(3):
        (s, o), (js, jo) = ours.sample_batch(), theirs.sample_batch()
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(o, jo)
        patches = ours.extract(s, o)
        assert patches.dtype == torch.bfloat16 and tuple(patches.shape) == (3, *INITIAL, 1)
        np.testing.assert_array_equal(_as_f32(patches), _as_f32(theirs.extract(js, jo)))
    (s, o), (js, jo) = ours.sample_chunk(2), theirs.sample_chunk(2)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(o, jo)


def test_device_cache_with_seg_matches_jax(folder):
    """Supervised slots: the seg stacked after the data, -1 outside the case,
    split back off as int16 (the JAX trainer's extract), with probabilistic
    oversampling."""
    ours, theirs = _caches(folder, whole_dataset_mode=True, capacity_mb=64, include_seg=True,
                           probabilistic_oversampling=True)
    assert ours.num_channels == theirs.num_channels == 2
    np.testing.assert_array_equal(_as_f32(ours.cache), _as_f32(theirs.cache))
    assert (_as_f32(ours.cache)[..., 1] == -1).any()
    for _ in range(3):
        (s, o), (js, jo) = ours.sample_batch(), theirs.sample_batch()
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(o, jo)
        data, seg = ours.extract_split(s, o)
        ref = np.asarray(theirs.extract(js, jo))
        assert data.dtype == torch.bfloat16 and seg.dtype == torch.int16
        np.testing.assert_array_equal(_as_f32(data), _as_f32(ref[..., :1]))
        np.testing.assert_array_equal(seg.numpy(), ref[..., 1:].astype(np.int16))


def test_device_cache_refill_matches_jax(folder):
    """One staged slot, applied by maybe_refill, lands in the same slot with
    the same contents in both packages."""
    import time
    ours, theirs = _caches(folder, whole_dataset_mode=False, capacity_mb=1)
    try:
        for c in (ours, theirs):
            c.start_refill(steps_per_slot=1)
            deadline = time.time() + 60
            while c._refill_queue.empty() and time.time() < deadline:
                time.sleep(0.05)
            assert c.maybe_refill() == 1
        assert ours.slots_refilled == 1
        assert [m.key for m in ours.meta] == [m.key for m in theirs.meta]
        np.testing.assert_array_equal(_as_f32(ours.cache), _as_f32(theirs.cache))
    finally:
        ours.stop()
        theirs.stop()
    assert not ours._refill_thread.is_alive()


def test_linear_warmup_cosine_matches_jax():
    kw = dict(warmup_steps=6, total_steps=20, warmup_start_lr=1e-6)
    ours = schedules.linear_warmup_cosine_schedule(1e-4, **kw)
    theirs = jax_schedules.linear_warmup_cosine_schedule(1e-4, **kw)
    for step in range(24):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6)
    poly, jpoly = schedules.poly_lr_schedule(1e-2, 20), jax_schedules.poly_lr_schedule(1e-2, 20)
    for step in range(22):
        np.testing.assert_allclose(poly(step), float(jpoly(step)), rtol=1e-6, atol=1e-12)


def test_crossval_split_and_dataset_name(tmp_path, monkeypatch):
    keys = [f"case_{i:03d}" for i in range(11)]
    assert generate_crossval_split(keys) == jax_split(keys)
    (tmp_path / "Dataset123_Foo").mkdir()
    monkeypatch.setenv("ATK_preprocessed", str(tmp_path))
    assert maybe_convert_to_dataset_name(123) == "Dataset123_Foo"
    assert maybe_convert_to_dataset_name("Dataset123_Foo") == "Dataset123_Foo"
    with pytest.raises(RuntimeError):
        maybe_convert_to_dataset_name(124)

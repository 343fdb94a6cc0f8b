"""anatomask_torch.preprocessing against anatomask_tpu.preprocessing on the
CPU: the port's copies of cropping, normalization, resampling (data, seg,
separate z, no-op) and DefaultPreprocessor.run_case_npy are the same host
arithmetic, so every output is held bit for bit (assert_array_equal) and
every property for equality. Inputs come from numpy seeds."""
import copy
from functools import partial

import numpy as np
import pytest

from anatomask_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from anatomask_tpu.preprocessing import cropping as jc
from anatomask_tpu.preprocessing import normalization as jn
from anatomask_tpu.preprocessing import preprocessor as jp
from anatomask_tpu.preprocessing import resampling as jr
from anatomask_torch import configuration
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.preprocessing import cropping as tc
from anatomask_torch.preprocessing import normalization as tn
from anatomask_torch.preprocessing import preprocessor as tp
from anatomask_torch.preprocessing import resampling as tr


def _volume(seed, shape=(2, 14, 12, 10), box=((2, 11), (3, 10), (1, 8))):
    """Noise inside a box, zeros outside, one zero voxel inside (a hole the
    mask fills) and one stray nonzero voxel outside the box's interior."""
    rs = np.random.RandomState(seed)
    data = np.zeros(shape, np.float32)
    sl = tuple(slice(lo, hi) for lo, hi in box)
    data[(slice(None), *sl)] = rs.rand(shape[0], *[hi - lo for lo, hi in box]) * 50 + 1
    data[:, 5, 6, 4] = 0.0
    data[1, 12, 1, 9] = 3.0
    return data


def test_nonzero_mask_and_bbox_are_jax_s():
    data = _volume(90)
    mask = tc.create_nonzero_mask(data)
    np.testing.assert_array_equal(mask, jc.create_nonzero_mask(data))
    assert tc.get_bbox_from_mask(mask) == jc.get_bbox_from_mask(mask)
    assert tc.get_bbox_from_mask(np.zeros((3, 4, 5), bool)) == [[0, 3], [0, 4], [0, 5]]


@pytest.mark.parametrize("with_seg", [False, True])
def test_crop_to_nonzero_is_jax_s(with_seg):
    data = _volume(91)
    seg = None
    if with_seg:
        seg = np.zeros((1, *data.shape[1:]), np.int8)
        seg[0, 4:8, 4:8, 2:6] = 2
    got = tc.crop_to_nonzero(data.copy(), None if seg is None else seg.copy())
    ref = jc.crop_to_nonzero(data.copy(), None if seg is None else seg.copy())
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].dtype == ref[1].dtype
    assert got[2] == ref[2]


@pytest.mark.parametrize("scheme,mask", [
    ("ZScoreNormalization", False), ("ZScoreNormalization", True), ("CTNormalization", False),
    ("CT", False), ("NoNormalization", False), ("RescaleTo01Normalization", False),
    ("RGBTo01Normalization", False)])
def test_normalization_schemes_are_jax_s(scheme, mask):
    rs = np.random.RandomState(92)
    image = (rs.rand(9, 8, 7) * 255).astype(np.float32)
    seg = np.where(rs.rand(9, 8, 7) > 0.3, 0, -1).astype(np.int8)
    props = {"mean": 80.0, "std": 30.0, "percentile_00_5": 10.0, "percentile_99_5": 200.0}
    got = tn.get_normalization_scheme(scheme)(mask, props).run(image.copy(), seg)
    ref = jn.get_normalization_scheme(scheme)(mask, props).run(image.copy(), seg)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    assert (tn.get_normalization_scheme(scheme)
            .leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true
            == jn.get_normalization_scheme(scheme)
            .leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true)


def test_channel_names_map_to_jax_s_schemes():
    for name in ("CT", "ct", "noNorm", "none", "label", "rescale_to_0_1", "rgb", "T1", "MR"):
        assert (tn.channel_name_to_normalization_scheme(name)
                == jn.channel_name_to_normalization_scheme(name))
    with pytest.raises(RuntimeError, match="Unknown normalization"):
        tn.get_normalization_scheme("Whitening")


def test_shape_and_axis_helpers_are_jax_s():
    assert configuration.ANISO_THRESHOLD == jr.ANISO_THRESHOLD
    for old, sp, new in (([100, 100, 50], [1.0, 1.0, 2.0], [0.5, 0.5, 1.0]),
                         ([155, 240, 240], [1.5, 1.0, 1.0], [1.0, 1.0, 1.0])):
        np.testing.assert_array_equal(tr.compute_new_shape(old, sp, new),
                                      jr.compute_new_shape(old, sp, new))
    for sp in ([1.0, 1.0, 4.0], [1.0, 1.0, 2.0], [3.5, 1.0, 1.0]):
        assert tr.get_do_separate_z(sp) == jr.get_do_separate_z(sp)
        np.testing.assert_array_equal(tr.get_lowres_axis(sp), jr.get_lowres_axis(sp))
    for n_in, n_out, order in ((9, 14, 3), (10, 7, 1), (4, 8, 0)):
        np.testing.assert_array_equal(tr._interp_matrix(n_in, n_out, order),
                                      jr._interp_matrix(n_in, n_out, order))


@pytest.mark.parametrize("case", ["data", "seg", "separate_z", "noop", "to_spacing"])
def test_resampling_is_jax_s(case):
    rs = np.random.RandomState(93)
    data = rs.rand(2, 9, 10, 11).astype(np.float32)
    if case == "data":
        args = (data, (14, 7, 17), [1.0, 1.0, 1.0], [9 / 14, 10 / 7, 11 / 17])
        kw = dict(is_seg=False, order=3, force_separate_z=None)
    elif case == "seg":
        seg = np.zeros((1, 12, 12, 12), np.int8)
        seg[0, 3:9, 3:9, 3:9] = 2
        seg[0, 5:7, 5:7, 5:7] = 1
        args = (seg, (18, 17, 9), [1.0, 1.0, 1.0], [2 / 3, 12 / 17, 4 / 3])
        kw = dict(is_seg=True, order=1, force_separate_z=None)
    elif case == "separate_z":
        args = (data[:, :, :, :4], (16, 16, 8), [1.0, 1.0, 4.0], [0.5, 0.5, 2.0])
        kw = dict(is_seg=False, order=3, order_z=0, force_separate_z=None)
    elif case == "noop":
        args = (data, (9, 10, 11), [1, 1, 1], [1, 1, 1])
        kw = {}
    else:
        got = tr.get_resampling_fn("resample_data_or_seg_to_spacing")(
            data, [1.0, 1.0, 1.5], [1.0, 1.0, 1.0], order=3)
        ref = jr.get_resampling_fn("resample_data_or_seg_to_spacing")(
            data, [1.0, 1.0, 1.5], [1.0, 1.0, 1.0], order=3)
        np.testing.assert_array_equal(got, ref)
        assert got.shape == (2, 9, 10, 16)
        return
    got = tr.get_resampling_fn("resample_data_or_seg_to_shape")(*args, **kw)
    ref = jr.resample_data_or_seg_to_shape(*args, **kw)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    with pytest.raises(RuntimeError, match="Unknown resampling"):
        tr.get_resampling_fn("resample_with_torch")


def _plans(transpose):
    """A 3d_fullres configuration as the planner writes one, at a target
    spacing that resamples every axis."""
    kw_data = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    kw_seg = {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None}
    back = [transpose.index(i) for i in range(3)]
    return {
        "dataset_name": "Dataset999_Tiny", "plans_name": "tinyPlans",
        "transpose_forward": transpose, "transpose_backward": back,
        "image_reader_writer": "NiftiIO",
        "foreground_intensity_properties_per_channel": {
            "1": {"mean": 20.0, "std": 9.0, "percentile_00_5": 2.0, "percentile_99_5": 45.0}},
        "configurations": {"3d_fullres": {
            "data_identifier": "tinyPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
            "spacing": [0.8, 1.25, 1.1], "patch_size": [8, 8, 8],
            "normalization_schemes": ["ZScoreNormalization", "CTNormalization"],
            "use_mask_for_norm": [True, False],
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": kw_data, "resampling_fn_seg_kwargs": kw_seg,
            "resampling_fn_probabilities_kwargs": dict(kw_data, order=1)}}}


@pytest.mark.parametrize("with_seg,transpose", [(False, [0, 1, 2]), (True, [2, 0, 1])])
def test_run_case_npy_is_jax_s(with_seg, transpose):
    """Transpose, crop, normalize (masked z-score and CT), resample, and
    with a segmentation the class locations: bit-equal data and seg, equal
    properties."""
    data = _volume(94)
    seg = None
    if with_seg:
        seg = np.zeros((1, *data.shape[1:]), np.int8)
        seg[0, 4:8, 4:8, 2:6] = 1
        seg[0, 6:10, 5:9, 4:7] = 2
    props = {"spacing": [1.0, 1.5, 0.9]}
    dataset_json = {"labels": {"background": 0, "a": 1, "b": 2}}
    plans = _plans(transpose)
    pm, jpm = PlansManager(plans), JaxPlansManager(plans)
    cm, jcm = pm.get_configuration("3d_fullres"), jpm.get_configuration("3d_fullres")
    got_props, ref_props = copy.deepcopy(props), copy.deepcopy(props)
    got = cm.preprocessor_class().run_case_npy(data, seg, got_props, pm, cm, dataset_json)
    ref = jcm.preprocessor_class().run_case_npy(data, seg, ref_props, jpm, jcm, dataset_json)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert g.dtype == r.dtype
    assert got[0].shape[1:] != data.shape[1:]  # cropped and resampled
    locs = got_props.pop("class_locations", {})
    ref_locs = ref_props.pop("class_locations", {})
    assert got_props == ref_props
    assert locs.keys() == ref_locs.keys() and bool(locs) == with_seg
    for k in ref_locs:
        np.testing.assert_array_equal(locs[k], ref_locs[k])


def test_configuration_accessors_resolve_every_jax_name():
    """Every resampling function and preprocessor the JAX package names
    resolves to the port's counterpart, bound to the plans' kwargs."""
    for name in jr._RESAMPLING_FNS:
        assert tr.get_resampling_fn(name).__name__ == name
    plans = _plans([0, 1, 2])
    cm = PlansManager(plans).get_configuration("3d_fullres")
    jcm = JaxPlansManager(plans).get_configuration("3d_fullres")
    for which in ("data", "seg", "probabilities"):
        got, ref = getattr(cm, f"resampling_fn_{which}"), getattr(jcm, f"resampling_fn_{which}")
        assert isinstance(got, partial) and got.keywords == ref.keywords
        assert got.func is tr.resample_data_or_seg_to_shape
    assert cm.preprocessor_class is tp.DefaultPreprocessor
    assert tp.get_preprocessor_class("DefaultPreprocessor").__name__ == \
        jp.get_preprocessor_class("DefaultPreprocessor").__name__
    with pytest.raises(RuntimeError, match="Unknown preprocessor"):
        tp.get_preprocessor_class("ResEncPreprocessor")


def test_run_case_save_writes_what_jax_reads(tmp_path):
    """run_case_save from NIfTI files: the JAX package's load_properties
    reads the port's properties back."""
    from anatomask_torch.imageio.nifti import write_nifti
    data = _volume(95)
    files = []
    for c in range(2):
        files.append(str(tmp_path / f"case_{c:04d}.nii.gz"))
        write_nifti(files[-1], np.ascontiguousarray(data[c].T), spacing_xyz=(0.9, 1.5, 1.0))
    seg_file = str(tmp_path / "case.nii.gz")
    seg = np.zeros(data.shape[1:], np.uint8)
    seg[4:8, 4:8, 2:6] = 1
    write_nifti(seg_file, np.ascontiguousarray(seg.T), spacing_xyz=(0.9, 1.5, 1.0))
    plans = _plans([0, 1, 2])
    pm = PlansManager(plans)
    dataset_json = {"labels": {"background": 0, "a": 1}}
    tp.DefaultPreprocessor().run_case_save(str(tmp_path / "out"), files, seg_file, pm,
                                           pm.get_configuration("3d_fullres"), dataset_json)
    jpm = JaxPlansManager(plans)
    ref = jp.DefaultPreprocessor().run_case(files, seg_file, jpm,
                                            jpm.get_configuration("3d_fullres"), dataset_json)
    with np.load(tmp_path / "out.npz") as z:
        np.testing.assert_array_equal(z["data"], ref[0])
        np.testing.assert_array_equal(z["seg"], ref[1])
    props = jp.load_properties(str(tmp_path / "out"))
    for k in ("spacing", "shape_before_cropping", "bbox_used_for_cropping"):
        assert np.array_equal(np.asarray(props[k]), np.asarray(ref[2][k])), k
    np.testing.assert_array_equal(props["class_locations"][1], ref[2]["class_locations"][1])

"""Prediction from raw image files: anatomask_torch's Predictor against
anatomask_tpu's on the CPU in float32, with a tiny PlainConvUNet in a
trained-model folder that the JAX package's checkpoint writer filled, over
NIfTI cases (two channels, z-score with the nonzero mask and CT
normalization, cropping, one case resampled from 1.5 mm). Also the sliding
window's out-of-memory ladder with an injected torch.cuda.OutOfMemoryError,
and the padded last tile batch under BatchNorm."""
import json
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from anatomask_tpu.imageio.nifti import read_nifti, write_nifti
from anatomask_tpu.inference import sliding_window as jsw
from anatomask_tpu.inference.predictor import Predictor as JaxPredictor
from anatomask_tpu.models.build import build_network_from_plans as jax_build
from anatomask_tpu.models.plain_unet import PlainConvUNet as JaxPlainConvUNet
from anatomask_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from anatomask_tpu.training.checkpoint import save_checkpoint
from anatomask_torch.convert import plain_unet_state_dict_from_jax
from anatomask_torch.imageio.nifti import NiftiIO
from anatomask_torch.inference import predictor as pred_mod
from anatomask_torch.inference import sliding_window as tsw
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.models.plain_unet import PlainConvUNet

from torch_parity import jax_random_params

PATCH = (16, 16, 16)
# disk (x, y, z) shapes and spacings of the cases: after cropping to the
# nonzero cylinder (16 x 16 in x, y) and resampling to 1 mm both are
# (z, y, x) = (24, 16, 16), two tiles
CASES = {"case_a": ((20, 22, 24), (1.0, 1.0, 1.0)), "case_b": ((20, 22, 16), (1.0, 1.0, 1.5))}
OOM = "CUDA out of memory. Tried to allocate 2.00 GiB"


def _plans():
    kw_data = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    kw_seg = {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None}
    return {
        "dataset_name": "Dataset998_TinyRaw", "plans_name": "ATKPlans",
        "original_median_spacing_after_transp": [1.0, 1.0, 1.0],
        "original_median_shape_after_transp": [24, 16, 16],
        "image_reader_writer": "NibabelIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "experiment_planner_used": "ExperimentPlanner", "label_manager": "LabelManager",
        "foreground_intensity_properties_per_channel": {
            "1": {"mean": 40.0, "std": 12.0, "percentile_00_5": 5.0, "percentile_99_5": 90.0}},
        "configurations": {"3d_fullres": {
            "data_identifier": "ATKPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": 2, "patch_size": list(PATCH), "median_image_size_in_voxels": [24, 16, 16],
            "spacing": [1.0, 1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization", "CTNormalization"],
            "use_mask_for_norm": [True, False], "UNet_class_name": "PlainConvUNet",
            "UNet_base_num_features": 4, "unet_max_num_features": 16,
            "n_conv_per_stage_encoder": [2, 2, 2], "n_conv_per_stage_decoder": [2, 2],
            "num_pool_per_axis": [2, 2, 2],
            "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
            "conv_kernel_sizes": [[3, 3, 3]] * 3,
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": kw_data, "resampling_fn_seg_kwargs": kw_seg,
            "resampling_fn_probabilities_kwargs": dict(kw_data, order=1), "batch_dice": True}}}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(model folder, raw folder): one fold of a PlainConvUNet written by the
    JAX checkpoint writer, and the raw cases as NIfTI files, two channels
    each, nonzero inside a cylinder along z."""
    root = tmp_path_factory.mktemp("predict_files")
    model = root / "model"
    (model / "fold_0").mkdir(parents=True)
    plans = _plans()
    dataset = {"labels": {"background": 0, "a": 1, "b": 2}, "file_ending": ".nii.gz",
               "channel_names": {"0": "T1", "1": "CT"}}
    (model / "plans.json").write_text(json.dumps(plans))
    (model / "dataset.json").write_text(json.dumps(dataset))
    jpm = JaxPlansManager(plans)
    jnet = jax_build(jpm, jpm.get_configuration("3d_fullres"), 2, 3, deep_supervision=False)
    params = jax_random_params(jnet, (1, *PATCH, 2), seed=110)
    save_checkpoint(str(model / "fold_0" / "checkpoint_final.npz"), {"network_weights": params},
                    {"configuration_name": "3d_fullres", "network_arch_name": "PlainConvUNet",
                     "inference_allowed_mirroring_axes": [0, 1, 2]})
    raw = root / "raw"
    raw.mkdir()
    rs = np.random.RandomState(111)
    for name, (shape, spacing) in CASES.items():
        x, y = np.ogrid[:shape[0], :shape[1]]
        inside = ((x - 9.5) / 8) ** 2 + ((y - 10.5) / 8) ** 2 <= 1.0
        for c, scale in enumerate((100.0, 60.0)):
            vol = (rs.rand(*shape) * scale + 1.0).astype(np.float32) * inside[:, :, None]
            write_nifti(str(raw / f"{name}_{c:04d}.nii.gz"), vol, spacing_xyz=spacing)
    return str(model), str(raw)


@pytest.fixture(scope="module")
def predicted(setup, tmp_path_factory):
    """Both packages' predict_from_files into their own folders, with
    probabilities; the port through threads."""
    model, raw = setup
    out = tmp_path_factory.mktemp("predicted")
    ref = JaxPredictor()
    ref.initialize_from_trained_model_folder(model)
    ref.predict_from_files(raw, str(out / "jax"), save_probabilities=True,
                           num_processes_preprocessing=1, num_processes_segmentation_export=1)
    pred = Predictor(device="cpu")
    pred.initialize_from_trained_model_folder(model)
    got = pred.predict_from_files(raw, str(out / "port"), save_probabilities=True,
                                  num_processes_preprocessing=1,
                                  num_processes_segmentation_export=2)
    return out, pred, ref, got


def test_segmentation_files_match_jax(predicted):
    out, pred, _, got = predicted
    assert got == [str(out / "port" / name) for name in sorted(CASES)]
    assert [sorted(t) for t in pred.case_timings] == [["export", "fetch_wait",
                                                       "sliding_window"]] * len(CASES)
    for name, (shape, spacing) in CASES.items():
        seg, hdr = read_nifti(str(out / "port" / f"{name}.nii.gz"))
        ref, ref_hdr = read_nifti(str(out / "jax" / f"{name}.nii.gz"))
        assert seg.shape == ref.shape == shape
        assert np.mean(seg == ref) >= 0.9999
        assert set(np.unique(seg)) <= {0, 1, 2} and len(np.unique(seg)) > 1
        assert hdr["raw_header"] == ref_hdr["raw_header"]
        np.testing.assert_array_equal(hdr["affine"], ref_hdr["affine"])
        assert hdr["pixdim"][1:4] == pytest.approx(spacing)


def test_probabilities_and_provenance_match_jax(predicted):
    out = predicted[0]
    for name in CASES:
        with np.load(out / "port" / f"{name}.npz") as g, np.load(out / "jax" / f"{name}.npz") as r:
            got, ref = g["probabilities"], r["probabilities"]
        assert got.shape == ref.shape == (3, *CASES[name][0][::-1])
        assert float(np.abs(got - ref).max() / np.abs(ref).max()) <= 1e-4
        assert os.path.isfile(out / "port" / f"{name}.props.json")
    for f in ("dataset.json", "plans.json"):
        assert json.loads((out / "port" / f).read_text()) == json.loads((out / "jax" / f).read_text())
    args = json.loads((out / "port" / "predict_from_raw_data_args.json").read_text())
    ref = json.loads((out / "jax" / "predict_from_raw_data_args.json").read_text())
    assert args.keys() == ref.keys()
    assert args["configuration_name"] == ref["configuration_name"] == "3d_fullres"


def test_spawned_workers_give_the_same_files(setup, predicted, tmp_path):
    """Two spawned preprocessing workers (the plans rebuilt in each child)
    write what the threads wrote."""
    model, raw = setup
    pred = Predictor(device="cpu")
    pred.initialize_from_trained_model_folder(model)
    with Predictor._make_preprocessing_pool(2) as pool:
        assert isinstance(pool, ProcessPoolExecutor)
    pred.predict_from_files(raw, str(tmp_path), num_processes_preprocessing=2,
                            num_processes_segmentation_export=1)
    for name in CASES:
        np.testing.assert_array_equal(read_nifti(str(tmp_path / f"{name}.nii.gz"))[0],
                                      read_nifti(str(predicted[0] / "port" / f"{name}.nii.gz"))[0])


def test_overwrite_false_skips_done_cases(setup, predicted, tmp_path, monkeypatch):
    model, raw = setup
    _, pred, ref, _ = predicted
    for name in CASES:
        (tmp_path / f"{name}.nii.gz").write_bytes(b"")
    os.remove(tmp_path / "case_b.nii.gz")
    assert (pred._manage_input_and_output_lists(raw, str(tmp_path), overwrite=False)
            == ref._manage_input_and_output_lists(raw, str(tmp_path), overwrite=False))
    seen = []
    real = pred.predict_sliding_window_return_logits
    monkeypatch.setattr(pred, "predict_sliding_window_return_logits",
                        lambda data: seen.append(data.shape) or real(data))
    assert pred.predict_from_files(raw, str(tmp_path), overwrite=False,
                                   num_processes_preprocessing=1) == [str(tmp_path / "case_b")]
    assert len(seen) == 1 and (tmp_path / "case_b.nii.gz").stat().st_size > 0
    assert (tmp_path / "case_a.nii.gz").stat().st_size == 0
    assert pred.predict_from_files(raw, str(tmp_path), overwrite=False) == []


def test_predict_single_npy_array_agrees(setup, predicted):
    """The raw array and its properties -> the file's segmentation, and
    JAX's on >= 99.99% of voxels."""
    _, raw = setup
    out, pred, ref, _ = predicted
    files = [os.path.join(raw, f"case_b_{c:04d}.nii.gz") for c in range(2)]
    image, props = NiftiIO().read_images(files)
    got = pred.predict_single_npy_array(image, props)
    seg = np.asarray(NiftiIO().read_seg(str(out / "port" / "case_b.nii.gz"))[0][0])
    np.testing.assert_array_equal(got, seg)
    assert np.mean(got == ref.predict_single_npy_array(image, props)) >= 0.9999


def test_is_oom_error_classification():
    """Device allocation failures step down the ladder; every other error
    surfaces (as JAX's test_is_oom_error_classification)."""
    assert tsw.is_oom_error(torch.cuda.OutOfMemoryError(OOM))
    assert tsw.is_oom_error(RuntimeError("CUDA error: out of memory"))
    assert tsw.is_oom_error(RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"))
    assert tsw.is_oom_error(RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"))
    assert not tsw.is_oom_error(RuntimeError("conv kernel launch failed with CUDA error 700"))
    assert not tsw.is_oom_error(ValueError("Out of memory"))
    assert not tsw.is_oom_error(MemoryError("Out of memory"))


def test_oom_ladder_steps_down_to_host_accumulation(setup, monkeypatch):
    """An injected OutOfMemoryError in the device-resident path at tile batch
    2, then 1, then in the streaming path's device accumulators: the
    prediction steps down each rung and ends on host accumulation at tile
    batch 1, with the direct run's logits. A non-OOM error surfaces."""
    model, _ = setup
    pred = Predictor(device="cpu", tile_batch_size=2)
    pred.initialize_from_trained_model_folder(model)
    data = np.random.RandomState(112).rand(2, 24, 20, 16).astype(np.float32)
    direct = pred.predict_sliding_window_return_logits(data)
    calls = []

    def oom_resident(*args, tile_batch_size, **kw):
        calls.append(("device_resident", tile_batch_size))
        raise torch.cuda.OutOfMemoryError(OOM)

    real_stream, real_predict = tsw.sliding_window_predict, tsw._predict

    def streaming(*args, tile_batch_size, **kw):
        calls.append(("streaming", tile_batch_size))
        return real_stream(*args, tile_batch_size=tile_batch_size, **kw)

    def predict(*args):
        acc_device = args[-1]
        calls.append(("accumulate", acc_device.type, len(calls)))
        if len(calls) == 4:  # the streaming path's device accumulation
            raise torch.cuda.OutOfMemoryError(OOM)
        return real_predict(*args)

    monkeypatch.setattr(pred_mod, "sliding_window_predict_device_resident", oom_resident)
    monkeypatch.setattr(pred_mod, "sliding_window_predict", streaming)
    monkeypatch.setattr(tsw, "_predict", predict)
    got = pred.predict_sliding_window_return_logits(data)
    assert calls == [("device_resident", 2), ("device_resident", 1), ("streaming", 1),
                     ("accumulate", "cpu", 3), ("accumulate", "cpu", 4)]
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-6)

    def broken(*args, **kw):
        raise RuntimeError("conv kernel launch failed with CUDA error 700")

    monkeypatch.setattr(pred_mod, "sliding_window_predict_device_resident", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        pred.predict_sliding_window_return_logits(data)


def test_streaming_spills_to_host_accumulation(monkeypatch):
    """The streaming path alone: an OutOfMemoryError in its device
    accumulation starts it again in host memory, with the same logits; any
    other error surfaces."""
    data = np.random.RandomState(113).rand(1, 20, 24, 18).astype(np.float32)

    def tile_fn(x):
        return torch.cat([x * 0.5, x ** 2], dim=-1)

    kw = dict(tile_batch_size=3, device="cpu")
    direct = tsw.sliding_window_predict(data, tile_fn, PATCH, 2, **kw)
    real_predict, seen = tsw._predict, []

    def predict(*args, error=torch.cuda.OutOfMemoryError(OOM)):
        seen.append(args[-1])
        if len(seen) == 1:
            raise error
        return real_predict(*args)

    monkeypatch.setattr(tsw, "_predict", predict)
    np.testing.assert_array_equal(tsw.sliding_window_predict(data, tile_fn, PATCH, 2, **kw),
                                  direct)
    assert seen == [torch.device("cpu")] * 2
    seen.clear()
    monkeypatch.setattr(tsw, "_predict", lambda *a: predict(*a, error=RuntimeError("no")))
    with pytest.raises(RuntimeError, match="no"):
        tsw.sliding_window_predict(data, tile_fn, PATCH, 2, **kw)
    assert len(seen) == 1


@pytest.mark.parametrize("path", ["device_resident", "streaming"])
def test_padded_last_batch_matches_jax_under_batch_norm(path):
    """Five tiles in batches of 3 through a BatchNorm PlainConvUNet (no TTA):
    the last batch padded with duplicates of its last tile matches JAX,
    which pads it so; run with its two tiles alone, it does not."""
    kw = dict(input_channels=1, num_classes=2, n_stages=2, features_per_stage=(4, 8),
              kernel_sizes=[[3, 3, 3]] * 2, strides=[[1, 1, 1], [2, 2, 2]],
              n_conv_per_stage=(1, 1), n_conv_per_stage_decoder=(1,), deep_supervision=False,
              norm="batch")
    jnet = JaxPlainConvUNet(**kw)
    params = jax_random_params(jnet, (1, 8, 8, 8, 1), seed=114)
    net = PlainConvUNet(**kw).eval()
    net.load_state_dict(plain_unet_state_dict_from_jax(params), strict=True)
    data = np.random.RandomState(115).rand(1, 8, 8, 24).astype(np.float32)

    def port_tile(x):
        return net(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).float()

    def unpadded_tile(x):  # the trailing copies of the last tile dropped
        n = len(x)
        while n > 1 and torch.equal(x[n - 1], x[n - 2]):
            n -= 1
        out = port_tile(x[:n])
        return torch.cat([out, out[-1:].expand(len(x) - n, *out.shape[1:])])

    fns = {"device_resident": (jsw.sliding_window_predict_device_resident,
                               tsw.sliding_window_predict_device_resident),
           "streaming": (jsw.sliding_window_predict, tsw.sliding_window_predict)}[path]
    args = ((8, 8, 8), 2)
    ref = fns[0](data, lambda x: jnet.apply({"params": params}, x), *args, tile_step_size=0.5,
                 tile_batch_size=3)
    got = fns[1](data, port_tile, *args, tile_batch_size=3, device="cpu")
    unpadded = fns[1](data, unpadded_tile, *args, tile_batch_size=3, device="cpu")
    assert len(tsw.compute_steps_for_sliding_window((8, 8, 24), (8, 8, 8), 0.5)[2]) == 5

    def rel(a):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    assert rel(got) <= 1e-4
    assert rel(unpadded) > 1e-2

"""The 3d_lowres -> cascade path of anatomask_torch against anatomask_tpu on
the CPU in float32.

Prediction from files with a previous stage (ROADMAP.md §3 item 6): the JAX
package stacks the previous stage's segmentation as it was read, which
raises for any case that preprocessing crops or resamples; the port passes
it through run_case_npy as a seg and stacks the one-hot of what comes back
(nnU-Net's file iterator does the same). A case that is neither cropped nor
resampled preprocesses bit for bit alike in both.

Training, on one tiny dataset written by the JAX planner and preprocessor
(tests/test_cascade_e2e.py's tiny_lowres and tiny_cascade configurations):
the lowres stage's final validation with the same weights in both packages
(fold "all", so every case gets its predicted_next_stage, equal to JAX's);
the cascade's CaseDataset and its corrupted sampler batches bit-equal to
JAX's under one seed; the missing previous stage's RuntimeError; the host
pipeline in place of the case cache; the first cascade step's loss against
JAX's on the same weights; a run of the port's cascade stage and its final
validation, whose inputs stack the previous stage's one-hot as nnU-Net does
and whose logits match the JAX Predictor's on the same stacked input. The
JAX trainer's own final validation of the cascade raises (ROADMAP.md §3 item
7)."""
import json
import os
from dataclasses import asdict

import flax.errors
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.data.dataset import CaseDataset as JaxCaseDataset
from anatomask_tpu.data.sampler import PatchSampler as JaxPatchSampler
from anatomask_tpu.imageio.nifti import write_nifti
from anatomask_tpu.inference.predictor import Predictor as JaxPredictor
from anatomask_tpu.inference.predictor import _preprocess_case_worker
from anatomask_tpu.models.build import build_network_from_plans as jax_build
from anatomask_tpu.plans.label_handling import convert_labelmap_to_one_hot as jax_one_hot
from anatomask_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from anatomask_tpu.plans.plans_handler import load_json, save_json
from anatomask_tpu.training import trainer as jax_trainer_mod
from anatomask_tpu.training.checkpoint import save_checkpoint
from anatomask_torch.convert import state_dict_from_jax, state_dict_to_jax
from anatomask_torch.data.dataset import CaseDataset
from anatomask_torch.data.sampler import PatchSampler
from anatomask_torch.imageio.nifti import NiftiIO
from anatomask_torch.inference.predictor import Predictor, _preprocess_case
from anatomask_torch.plans.label_handling import convert_labelmap_to_one_hot
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.training.trainer import Trainer, TrainerConfig
from synthetic import make_synthetic_dataset, setup_env
from test_torch_predict_files import _plans as files_plans
from test_torch_supervised import _SeededInit
from torch_parity import jax_random_params

# --- prediction from files (item 6) -------------------------------------------

FILES_PATCH = (16, 16, 16)
# disk (x, y, z) shape, spacing, nonzero only inside a cylinder along z (so
# cropping bites); case_b is resampled from 1.5 mm, case_c neither cropped
# nor resampled
RAW_CASES = {"case_a": ((20, 22, 24), (1.0, 1.0, 1.0), True),
             "case_b": ((20, 22, 16), (1.0, 1.0, 1.5), True),
             "case_c": ((16, 16, 24), (1.0, 1.0, 1.0), False)}
FG = (1, 2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A cascade model folder (test_torch_predict_files.py's plans with a
    `3d_cascade` configuration whose previous stage is 3d_fullres; a
    PlainConvUNet of 2 + 2 input channels written by the JAX checkpoint
    writer), the raw cases (two channels) and a previous stage's
    segmentations on their raw grids (labels inside the nonzero region)."""
    root = tmp_path_factory.mktemp("cascade_files")
    model = root / "model"
    (model / "fold_0").mkdir(parents=True)
    plans = files_plans()
    plans["configurations"]["3d_cascade"] = {"inherits_from": "3d_fullres",
                                             "previous_stage": "3d_fullres"}
    dataset = {"labels": {"background": 0, "a": 1, "b": 2}, "file_ending": ".nii.gz",
               "channel_names": {"0": "T1", "1": "CT"}}
    (model / "plans.json").write_text(json.dumps(plans))
    (model / "dataset.json").write_text(json.dumps(dataset))
    jpm = JaxPlansManager(plans)
    jnet = jax_build(jpm, jpm.get_configuration("3d_cascade"), 4, 3, deep_supervision=False)
    params = jax_random_params(jnet, (1, *FILES_PATCH, 4), seed=120)
    save_checkpoint(str(model / "fold_0" / "checkpoint_final.npz"), {"network_weights": params},
                    {"configuration_name": "3d_cascade", "network_arch_name": "PlainConvUNet",
                     "inference_allowed_mirroring_axes": [0, 1, 2]})
    raw, prev = root / "raw", root / "prev"
    raw.mkdir()
    prev.mkdir()
    rs = np.random.RandomState(121)
    for name, (shape, spacing, cylinder) in RAW_CASES.items():
        x, y = np.ogrid[:shape[0], :shape[1]]
        inside = (((x - 9.5) / 8) ** 2 + ((y - 10.5) / 8) ** 2 <= 1.0 if cylinder
                  else np.ones(shape[:2], bool))[:, :, None]
        for c, scale in enumerate((100.0, 60.0)):
            vol = (rs.rand(*shape) * scale + 1.0).astype(np.float32) * inside
            write_nifti(str(raw / f"{name}_{c:04d}.nii.gz"), vol, spacing_xyz=spacing)
        labels = rs.choice(3, [(s + 3) // 4 for s in shape]).repeat(4, 0).repeat(4, 1).repeat(4, 2)
        seg = (labels[:shape[0], :shape[1], :shape[2]] * inside).astype(np.uint8)
        write_nifti(str(prev / f"{name}.nii.gz"), seg, spacing_xyz=spacing)
    return str(model), str(raw), str(prev), plans, dataset


def _managers(plans):
    pm = PlansManager(plans)
    return pm, pm.get_configuration("3d_cascade")


def _case_files(raw, name):
    return [os.path.join(raw, f"{name}_{c:04d}.nii.gz") for c in range(2)]


@pytest.mark.parametrize("name", ["case_a", "case_b"])
def test_previous_stage_is_preprocessed_unlike_jax(files, name):
    """A cropped case (and case_b, resampled from 1.5 mm too): JAX's worker
    raises in np.vstack; the port's stacked channels are the one-hot of the
    seg that run_case_npy returns for the previous stage's segmentation, and
    its data channels those of the case preprocessed without it, bit for
    bit."""
    _, raw, prev, plans, dataset = files
    prev_file = os.path.join(prev, f"{name}.nii.gz")
    with pytest.raises(ValueError, match="dimensions"):
        _preprocess_case_worker(plans, "3d_cascade", dataset, _case_files(raw, name), prev_file,
                                FG, False)
    pm, cm = _managers(plans)
    got, props = _preprocess_case(pm, cm, dataset, _case_files(raw, name), prev_file, FG, False)
    rw = pm.image_reader_writer_class()
    data, p1 = rw.read_images(_case_files(raw, name))
    seg_prev = rw.read_seg(prev_file)[0]
    assert seg_prev.shape[1:] == data.shape[1:]
    pp = cm.preprocessor_class(verbose=False)
    want_data, want_seg = pp.run_case_npy(data, seg_prev, p1, pm, cm, dataset)
    alone, _ = pp.run_case_npy(data, None, dict(rw.read_images(_case_files(raw, name))[1]), pm,
                               cm, dataset)
    assert got.shape == (4, *want_data.shape[1:]) and got.dtype == np.float32
    assert want_data.shape[1:] != seg_prev.shape[1:]
    np.testing.assert_array_equal(got[:2], want_data)
    np.testing.assert_array_equal(got[:2], alone)
    np.testing.assert_array_equal(got[2:], convert_labelmap_to_one_hot(want_seg[0], FG,
                                                                       np.float32))
    assert got[2:].any(axis=(1, 2, 3)).all()
    assert props["bbox_used_for_cropping"] == p1["bbox_used_for_cropping"]


def test_uncropped_case_matches_jax(files):
    """case_c is neither cropped nor resampled: both packages' preprocessing
    with the previous stage agree bit for bit."""
    _, raw, prev, plans, dataset = files
    args = (dataset, _case_files(raw, "case_c"), os.path.join(prev, "case_c.nii.gz"), FG, False)
    ref, _ = _preprocess_case_worker(plans, "3d_cascade", *args)
    got, _ = _preprocess_case(*_managers(plans), *args)
    assert got.shape == ref.shape == (4, 24, 16, 16)
    np.testing.assert_array_equal(got, ref)


def test_cascade_predicts_from_files(files, tmp_path):
    """predict_from_files with the previous stage's folder writes every case
    at its raw shape; case_c's segmentation equals the JAX Predictor's; case_b's
    equals predict_single_npy_array given its preprocessed previous stage."""
    model, raw, prev, plans, dataset = files
    pred = Predictor(device="cpu")
    pred.initialize_from_trained_model_folder(model)
    out = str(tmp_path / "port")
    pred.predict_from_files(raw, out, folder_with_segs_from_prev_stage=prev,
                            num_processes_preprocessing=1, num_processes_segmentation_export=1)
    io = NiftiIO()
    segs = {}
    for name, (shape, _, _) in RAW_CASES.items():
        segs[name] = io.read_seg(os.path.join(out, f"{name}.nii.gz"))[0][0]
        assert segs[name].shape == shape[::-1] and set(np.unique(segs[name])) <= {0, 1, 2}
    ref = JaxPredictor()
    ref.initialize_from_trained_model_folder(model)
    ref.predict_from_files([_case_files(raw, "case_c")], [str(tmp_path / "jax_case_c")],
                           folder_with_segs_from_prev_stage=prev,
                           num_processes_preprocessing=1, num_processes_segmentation_export=1)
    np.testing.assert_array_equal(io.read_seg(str(tmp_path / "jax_case_c.nii.gz"))[0][0],
                                  segs["case_c"])
    rw = pred.plans_manager.image_reader_writer_class()
    data, props = rw.read_images(_case_files(raw, "case_b"))
    _, seg_pp = pred.configuration_manager.preprocessor_class(verbose=False).run_case_npy(
        data, rw.read_seg(os.path.join(prev, "case_b.nii.gz"))[0], dict(props),
        pred.plans_manager, pred.configuration_manager, dataset)
    single = pred.predict_single_npy_array(data, props, seg_pp[0])
    np.testing.assert_array_equal(single, segs["case_b"])


# --- planning -------------------------------------------------------------------

def test_planner_plans_the_chip_cascade(tmp_path, monkeypatch):
    """The fingerprint of chip_smoke.py's cascade dataset (CASCADE_TRAIN:
    KiTS-like CT of 224x256x256 at 1.0x0.8x0.8 mm) planned by both
    packages: equal plans files, with 3d_lowres and the cascade as
    chip_smoke.check_cascade_plans expects them, and a cascade network of
    CASCADE_IN input channels."""
    import chip_smoke
    from anatomask_tpu.planning import planner as jplanner
    from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
    from anatomask_torch.planning import planner as tplanner
    from anatomask_torch.plans.label_handling import determine_num_input_channels
    dirs = {w: str(tmp_path / w) for w in ("raw", "preprocessed", "results")}
    for w, d in dirs.items():
        os.makedirs(d)
        monkeypatch.setenv(f"ATK_{w}", d)
    name = chip_smoke.CASCADE_DATASET
    raw = os.path.join(dirs["raw"], name)
    os.makedirs(os.path.join(raw, "imagesTr"))
    open(os.path.join(raw, "imagesTr", "case_000_0000.nii.gz"), "w").close()
    generate_dataset_json(raw, {0: "CT"}, chip_smoke.CLI_LABELS, len(chip_smoke.CASCADE_TRAIN),
                          ".nii.gz")
    fg = {"mean": 120.0, "median": 150.0, "std": 60.0, "min": 40.0, "max": 250.0,
          "percentile_99_5": 230.0, "percentile_00_5": 50.0}
    pp = os.path.join(dirs["preprocessed"], name)
    os.makedirs(pp)
    with open(os.path.join(pp, "dataset_fingerprint.json"), "w") as f:
        json.dump({"spacings": [list(sp) for _, _, sp in chip_smoke.CASCADE_TRAIN],
                   "shapes_after_crop": [list(sh) for _, sh, _ in chip_smoke.CASCADE_TRAIN],
                   "foreground_intensity_properties_per_channel": {"0": fg},
                   "median_relative_size_after_cropping": 1.0}, f)
    plans = []
    for planner in (jplanner, tplanner):
        planner.ExperimentPlanner(name).plan_experiment()
        with open(os.path.join(pp, "ATKPlans.json")) as f:
            plans.append(json.load(f))
        os.remove(os.path.join(pp, "ATKPlans.json"))
    assert plans[0] == plans[1]
    chip_smoke.check_cascade_plans(plans[1])
    pm = PlansManager(plans[1])
    assert determine_num_input_channels(pm, "3d_cascade_fullres", {
        "channel_names": {"0": "CT"}, "labels": chip_smoke.CLI_LABELS}) == chip_smoke.CASCADE_IN


# --- training -------------------------------------------------------------------

DATASET = "Dataset914_TCasc"
TINY = {"patch_size": [16, 16, 16], "batch_size": 2, "UNet_base_num_features": 2,
        "unet_max_num_features": 4, "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2]],
        "conv_kernel_sizes": [[3, 3, 3]] * 2, "n_conv_per_stage_encoder": [1, 1],
        "n_conv_per_stage_decoder": [1], "num_pool_per_axis": [1, 1, 1], "batch_dice": True}
NAME = "TCasc"


def _model_dir(root, which, configuration):
    return os.path.join(str(root), which, f"{NAME}__ATKPlans__{configuration}")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_cascade_e2e.py's dataset and its tiny_lowres / tiny_cascade
    configurations."""
    root = tmp_path_factory.mktemp("cascade_train")
    raw, pp, _ = setup_env(root)
    make_synthetic_dataset(raw, DATASET, num_cases=5, shape=(18, 20, 22))
    from anatomask_tpu.planning.fingerprint import DatasetFingerprintExtractor
    from anatomask_tpu.planning.planner import ExperimentPlanner
    from anatomask_tpu.preprocessing.preprocessor import DefaultPreprocessor
    DatasetFingerprintExtractor(DATASET, num_processes=1).run()
    ExperimentPlanner(DATASET).plan_experiment()
    DefaultPreprocessor().run(DATASET, "3d_fullres", "ATKPlans", num_processes=1)
    plans_file = os.path.join(pp, DATASET, "ATKPlans.json")
    plans = load_json(plans_file)
    ident = plans["configurations"]["3d_fullres"]["data_identifier"]
    tiny = dict(TINY, inherits_from="3d_fullres", data_identifier=ident)
    plans["configurations"]["tiny_lowres"] = dict(tiny, next_stage="tiny_cascade")
    plans["configurations"]["tiny_cascade"] = dict(tiny, previous_stage="tiny_lowres")
    save_json(plans, plans_file, sort_keys=False)
    dataset_json = load_json(os.path.join(pp, DATASET, "dataset.json"))
    return root, plans_file, dataset_json, os.path.join(pp, DATASET, ident)


def _trainers(tiny, configuration, fold, **kw):
    """The JAX (seeded numpy weights, one device) and the port's Trainer of
    one configuration, each in its own results tree, the port holding the
    JAX one's initial weights."""
    root, plans_file, dataset_json, _ = tiny
    setup_env(root)
    cfg = TrainerConfig(name=NAME, num_epochs=1, num_iterations_per_epoch=2,
                        num_val_iterations_per_epoch=1, compute_dtype="float32", num_workers=1,
                        **kw)
    with pytest.MonkeyPatch.context() as mp:
        build = jax_trainer_mod.build_network_from_plans
        mp.setattr(jax_trainer_mod, "build_network_from_plans",
                   lambda *a, **k: _SeededInit(build(*a, **k)))
        mp.setenv("ATK_NUM_DEVICES", "1")
        jt = jax_trainer_mod.Trainer(plans_file, configuration, fold, dataset_json,
                                     jax_trainer_mod.TrainerConfig(**asdict(cfg)),
                                     output_folder=_model_dir(root, "jax", configuration))
        jt.initialize()
    pt = Trainer(plans_file, configuration, fold, dataset_json, cfg,
                 output_folder=_model_dir(root, "port", configuration), device="cpu")
    pt.initialize()
    pt.network.load_state_dict(state_dict_from_jax(pt.arch_name, jax.device_get(jt.params)))
    return jt, pt


@pytest.fixture(scope="module")
def lowres(tiny):
    """Both packages' tiny_lowres fold "all" (every case validated) through
    perform_actual_validation with the same weights: each writes every
    case's predicted_next_stage/tiny_cascade."""
    jt, pt = _trainers(tiny, "tiny_lowres", "all")
    with pytest.MonkeyPatch.context() as mp:
        build = jax_trainer_mod.build_network_from_plans
        mp.setattr(jax_trainer_mod, "build_network_from_plans",
                   lambda *a, **k: _SeededInit(build(*a, **k)))
        jt.perform_actual_validation()
    pt.perform_actual_validation()
    return [os.path.join(t.output_folder_base, "predicted_next_stage", "tiny_cascade")
            for t in (jt, pt)]


def test_predicted_next_stage_matches_jax(tiny, lowres):
    """The lowres stage's resampled predictions for the next stage, one for
    every case, equal to JAX's for the same weights, on the next stage's
    grid."""
    jdir, pdir = lowres
    keys = sorted(CaseDataset(tiny[3]).keys())
    assert sorted(f[:-4] for f in os.listdir(pdir)) == keys == sorted(
        f[:-4] for f in os.listdir(jdir))
    for k in keys:
        got, ref = np.load(os.path.join(pdir, k + ".npz"))["seg"], np.load(
            os.path.join(jdir, k + ".npz"))["seg"]
        np.testing.assert_array_equal(got, ref, err_msg=k)


def test_case_dataset_stacks_previous_stage_as_jax(tiny, lowres):
    folder = tiny[3]
    ref, got = JaxCaseDataset(folder, None, lowres[1]), CaseDataset(folder, None, lowres[1])
    for k in got.keys():
        (rd, rs, _), (gd, gs, _) = ref.load_case(k), got.load_case(k)
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(rd))
        np.testing.assert_array_equal(gs, rs)
        assert gs.shape == (2, *gd.shape[1:])


@pytest.mark.parametrize("p_binary, p_remove", [(0.4, 0.2), (1.0, 1.0)])
def test_corrupted_batches_match_jax(tiny, lowres, p_binary, p_remove):
    """The training sampler with cascade_corruption: four batches under one
    seed equal to JAX's, boxes, data and both seg channels; and the
    corruption alone, fed the same patch and seed, equal to JAX's."""
    folder = tiny[3]
    kw = dict(batch_size=3, patch_size=(20, 20, 20), final_patch_size=(16, 16, 16),
              oversample_foreground_percent=0.33, annotated_classes_key=(0, 1, 2), seed=77,
              cascade_corruption=True, cascade_p_binary_op=p_binary,
              cascade_p_remove_component=p_remove)
    ref = JaxPatchSampler(JaxCaseDataset(folder, None, lowres[1]), **kw)
    got = PatchSampler(CaseDataset(folder, None, lowres[1]), **kw)
    for _ in range(4):
        r, g = ref.generate_batch(), got.generate_batch()
        assert g["keys"] == r["keys"]
        np.testing.assert_array_equal(g["data"], r["data"])
        np.testing.assert_array_equal(g["seg"], r["seg"])
        assert g["seg"].shape[-1] == 2
    patch = np.asarray(CaseDataset(folder, None, lowres[1]).load_case("case_000")[1][1])
    ref.rng, got.rng = np.random.RandomState(5), np.random.RandomState(5)
    out = got._corrupt_previous_stage(patch)
    np.testing.assert_array_equal(out, ref._corrupt_previous_stage(patch))
    assert ref.rng.uniform() == got.rng.uniform()
    if p_binary == 1.0:
        assert not np.array_equal(out, patch)


def test_cascade_stage_needs_the_previous_stage(tiny):
    """Without <trainer>__<plans>__tiny_lowres/predicted_next_stage/tiny_cascade
    both trainers raise JAX's RuntimeError, word for word."""
    root, plans_file, dataset_json, _ = tiny
    setup_env(root)
    folder = os.path.join(str(root), "no_lowres", f"{NAME}__ATKPlans__tiny_cascade")
    msgs = []
    for t in (jax_trainer_mod.Trainer(plans_file, "tiny_cascade", 0, dataset_json,
                                      output_folder=folder),
              Trainer(plans_file, "tiny_cascade", 0, dataset_json, output_folder=folder,
                      device="cpu")):
        with pytest.raises(RuntimeError, match="requires previous-stage predictions") as e:
            t.get_dataloaders()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "Train tiny_lowres (incl. final validation) first" in msgs[1]


def _stop(t):
    t.loader_train.stop()
    t.loader_val.stop()


def test_cascade_uses_the_host_pipeline(tiny, lowres):
    """The case cache turns itself off for a cascade stage, with JAX's
    reason; only the training sampler corrupts the previous stage."""
    root, plans_file, dataset_json, _ = tiny
    setup_env(root)
    t = Trainer(plans_file, "tiny_cascade", 0, dataset_json,
                TrainerConfig(name=NAME, compute_dtype="float32", num_workers=1,
                              device_cache=True),
                output_folder=_model_dir(root, "port", "tiny_cascade"), device="cpu")
    t.initialize()
    t.get_dataloaders()
    _stop(t)
    assert t.device_cache_train is None and t.device_cache_val is None
    assert t.sampler_train.cascade_corruption and not t.sampler_val.cascade_corruption
    with open(os.path.join(t.output_folder, "training_log.txt")) as f:
        assert ("[device-cache] falling back to the host pipeline: cascade stage (prev-stage "
                "seg channels)") in f.read()
    assert t.aug_config.cascade_foreground_labels == t.val_config.cascade_foreground_labels == FG


def test_first_cascade_step_matches_jax(tiny, lowres):
    """One step (augmentation off) on a batch whose seg channel 1 is the
    previous stage: the loss to 1e-5 of JAX's on the same weights; the
    network reads 1 + 2 channels."""
    jt, pt = _trainers(tiny, "tiny_cascade", 0, do_data_augmentation=False)
    first = next(p for p in pt.network.parameters() if p.ndim == 5)
    assert first.shape[1] == 3
    rs = np.random.RandomState(9)
    data = rs.standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    seg = rs.randint(0, 3, (2, 16, 16, 16, 2)).astype(np.int16)
    seg[:, :3] = -1
    params = jax.tree_util.tree_map(jnp.array, jt.params)
    _, _, ref = jt._train_step(params, jt.optimizer.init(params), jax.random.PRNGKey(0),
                               jnp.asarray(data), jnp.asarray(seg))
    got = pt.train_step(torch.from_numpy(data), torch.from_numpy(seg))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_cascade_trains_and_validates(tiny, lowres, monkeypatch):
    """The port's cascade stage: run_training through the host pipeline,
    then perform_actual_validation, whose every input is the case's data
    with the one-hot of the previous stage stacked (JAX's CaseDataset and
    one-hot) and whose logits match the JAX Predictor's on that input with
    the trained weights (1e-5 of the largest); summary.json. The JAX
    trainer's final validation of the same stage raises: it predicts the
    data alone."""
    jt, pt = _trainers(tiny, "tiny_cascade", 0)
    pt.run_training()
    losses = pt.logger.logging["train_losses"]
    assert len(losses) == 1 and np.isfinite(losses).all()
    seen = []
    predict = Predictor.predict_sliding_window_return_logits

    def record(self, data):
        logits = predict(self, data)
        seen.append((data, logits))
        return logits

    monkeypatch.setattr(Predictor, "predict_sliding_window_return_logits", record)
    metrics = pt.perform_actual_validation()
    assert os.path.isfile(os.path.join(pt.output_folder, "validation", "summary.json"))
    assert np.isfinite(metrics["foreground_mean"]["Dice"])
    _, val_keys = pt.do_split()
    assert len(seen) == len(val_keys) > 0

    ref = JaxPredictor()
    cm = jt.configuration_manager
    net = jax_build(jt.plans_manager, cm, 3, 3, deep_supervision=False)
    ref.manual_initialization(net, jt.plans_manager, cm,
                              [state_dict_to_jax(pt.arch_name, pt.network.state_dict())],
                              jt.dataset_json, pt.inference_allowed_mirroring_axes)
    ds = JaxCaseDataset(pt.preprocessed_dataset_folder, val_keys, lowres[1])
    for k, (data, logits) in zip(val_keys, seen):
        d, s, _ = ds.load_case(k)
        want = np.vstack([np.asarray(d), jax_one_hot(np.asarray(s[-1]), FG,
                                                     output_dtype=np.float32)])
        np.testing.assert_array_equal(data, want)
        ref_logits = ref.predict_sliding_window_return_logits(want)
        np.testing.assert_allclose(logits, ref_logits, rtol=0,
                                   atol=1e-5 * np.abs(ref_logits).max())
    with pytest.MonkeyPatch.context() as mp:
        build = jax_trainer_mod.build_network_from_plans
        mp.setattr(jax_trainer_mod, "build_network_from_plans",
                   lambda *a, **k: _SeededInit(build(*a, **k)))
        with pytest.raises(flax.errors.ScopeParamShapeError, match=r"\(3, 3, 3, 1, 2\)"):
            jt.perform_actual_validation()

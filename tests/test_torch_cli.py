"""The port's command line (anatomask_torch/cli.py) on the CPU: every entry's
options against the JAX entry's (names, destinations, defaults, nargs,
types, choices; plus -device on train, pretrain and predict), a tiny run
from a raw dataset to a configuration choice (plan_and_preprocess -> train
two folds of ATKTrainer_1epoch on shrunk plans -> predict -> evaluate ->
ensemble -> find_best_configuration -> apply_postprocessing), the CLI's
predictions against the Predictor API's on the same folds, pretrain ->
train -pretrained_weights with the encoder transferred, training in 2 gloo
ranks (-num_gpus 2 -device cpu), and the refusals (-num_gpus 2 without two
cards; the default CUDA device without one)."""
import argparse
import importlib
import json
import os
import shutil
from dataclasses import replace

import numpy as np
import pytest
import torch

from anatomask_torch import cli
from anatomask_torch.imageio.nifti import read_nifti
from anatomask_torch.training import trainer as trainer_mod

from synthetic import make_synthetic_dataset

DATASET = "Dataset965_CliSynth"
ENTRIES = ("plan_and_preprocess", "extract_fingerprint", "plan_experiment", "preprocess",
           "train", "pretrain", "predict", "evaluate", "ensemble", "find_best_configuration",
           "determine_postprocessing", "apply_postprocessing", "export_model", "install_model",
           "move_plans", "accumulate_crossval", "download_model")
WITH_DEVICE = ("train", "pretrain", "predict")


class _Parsed(Exception):
    pass


def _options(entry, monkeypatch):
    """{dest: (option strings, default, nargs, type, choices, required)} of the
    parser that `entry` builds, taken as it parses."""
    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            entry([])
    parser = e.value.args[0]
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices, a.required)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_options_match_jax(name, monkeypatch):
    monkeypatch.setenv("ATK_COMPILE_CACHE", "")  # the JAX CLI writes no cache folder
    jcli = importlib.import_module("anatomask_tpu.cli")
    port = _options(getattr(cli, f"{name}_entry"), monkeypatch)
    jax = _options(getattr(jcli, f"{name}_entry"), monkeypatch)
    if name in WITH_DEVICE:
        assert port.pop("device") == (("-device",), "cuda", None, None, None, False)
    assert port == jax


@pytest.mark.parametrize("entry,argv", [
    ("train", ["1", "3d_fullres", "0", "-num_gpus", "2"]),
    ("pretrain", ["1", "-num_gpus", "2"]),
])
def test_more_than_one_gpu_raises(entry, argv):
    """-num_gpus above the visible cards on the default CUDA device raises
    with the count of visible cards: two ranks never share a card."""
    visible = torch.cuda.device_count()
    if visible >= 2:
        pytest.skip("checks the refusal on a machine with fewer than two CUDA cards")
    with pytest.raises(RuntimeError, match=f"2 ranks asked for and {visible} CUDA device"):
        getattr(cli, f"{entry}_entry")(argv)


@pytest.mark.parametrize("entry,argv", [
    ("train", ["1", "3d_fullres", "0"]), ("pretrain", ["1"]),
    ("predict", ["-i", "in", "-o", "out", "-d", "1", "-c", "3d_fullres"]),
])
def test_default_device_raises_without_cuda(entry, argv):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(cli, f"{entry}_entry")(argv)


def _env(root, monkeypatch):
    dirs = {w: os.path.join(str(root), w) for w in ("raw", "preprocessed", "results")}
    for w, d in dirs.items():
        os.makedirs(d, exist_ok=True)
        monkeypatch.setenv(f"ATK_{w}", d)
    monkeypatch.setenv("ATK_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("ATK_VAL_ITERS", "1")
    monkeypatch.setenv("ATK_N_PROC_DA", "1")
    return dirs


TINY = {"patch_size": [16, 16, 16], "batch_size": 2, "UNet_base_num_features": 4,
        "unet_max_num_features": 8, "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2]],
        "conv_kernel_sizes": [[3, 3, 3]] * 2, "n_conv_per_stage_encoder": [1, 1],
        "n_conv_per_stage_decoder": [1], "num_pool_per_axis": [1, 1, 1]}


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """A raw dataset with two test cases, planned and preprocessed by the
    CLI, its 3d_fullres plans shrunk to TINY; made once, copied by each test."""
    root = tmp_path_factory.mktemp("planned")
    with pytest.MonkeyPatch.context() as m:
        dirs = _env(root, m)
        raw, _ = make_synthetic_dataset(dirs["raw"], DATASET, num_cases=5, shape=(20, 22, 24),
                                        num_labels=2, seed=11)
        os.makedirs(os.path.join(raw, "labelsTs"))
        for i, case in enumerate(("case_000", "case_001")):
            shutil.copy(os.path.join(raw, "imagesTr", f"{case}_0000.nii.gz"),
                        os.path.join(raw, "imagesTs", f"test_{i}_0000.nii.gz"))
            shutil.copy(os.path.join(raw, "labelsTr", f"{case}.nii.gz"),
                        os.path.join(raw, "labelsTs", f"test_{i}.nii.gz"))
        cli.plan_and_preprocess_entry(["-d", "965", "-c", "3d_fullres", "-np", "1",
                                       "--verify_dataset_integrity"])
    plans_file = os.path.join(dirs["preprocessed"], DATASET, "ATKPlans.json")
    with open(plans_file) as f:
        plans = json.load(f)
    plans["configurations"]["3d_fullres"].update(TINY)
    with open(plans_file, "w") as f:
        json.dump(plans, f)
    return root


def _copy_planned(planned, tmp_path, monkeypatch):
    for w in ("raw", "preprocessed"):
        shutil.copytree(os.path.join(str(planned), w), str(tmp_path / w))
    dirs = _env(tmp_path, monkeypatch)
    return dirs, os.path.join(dirs["raw"], DATASET)


def _read_seg(path):
    return read_nifti(path)[0]


def test_cli_from_raw_dataset_to_best_configuration(planned, tmp_path, monkeypatch):
    dirs, raw = _copy_planned(planned, tmp_path, monkeypatch)
    tr = "ATKTrainer_1epoch"
    for fold in ("0", "1"):
        cli.train_entry(["965", "3d_fullres", fold, "-tr", tr, "--npz", "-device", "cpu"])
    model = os.path.join(dirs["results"], DATASET, f"{tr}__ATKPlans__3d_fullres")
    for fold in (0, 1):
        assert os.path.isfile(os.path.join(model, f"fold_{fold}", "checkpoint_final.npz"))
        assert os.path.isfile(os.path.join(model, f"fold_{fold}", "validation", "summary.json"))

    pred01, pred0 = str(tmp_path / "pred01"), str(tmp_path / "pred0")
    cli.predict_entry(["-i", os.path.join(raw, "imagesTs"), "-o", pred01, "-d", "965",
                       "-c", "3d_fullres", "-tr", tr, "-f", "0", "1", "--save_probabilities",
                       "-device", "cpu"])
    from anatomask_torch.inference.predictor import Predictor
    api = Predictor(dtype=torch.bfloat16, device="cpu")
    api.initialize_from_trained_model_folder(model, [0, 1])
    api_out = str(tmp_path / "api01")
    api.predict_from_files(os.path.join(raw, "imagesTs"), api_out, save_probabilities=True,
                           num_processes_preprocessing=1)
    for case in ("test_0", "test_1"):
        seg = _read_seg(os.path.join(pred01, case + ".nii.gz"))
        np.testing.assert_array_equal(seg, _read_seg(os.path.join(api_out, case + ".nii.gz")))
        assert set(np.unique(seg)) <= {0, 1, 2}
        with np.load(os.path.join(pred01, case + ".npz")) as a, \
                np.load(os.path.join(api_out, case + ".npz")) as b:
            np.testing.assert_array_equal(a["probabilities"], b["probabilities"])

    cli.predict_entry(["-i", os.path.join(raw, "imagesTs"), "-o", pred0, "-d", DATASET,
                       "-c", "3d_fullres", "-tr", tr, "-f", "0", "--save_probabilities",
                       "-device", "cpu"])
    for folder in (pred01, pred0):
        cli.evaluate_entry([os.path.join(raw, "labelsTs"), folder, "-np", "1"])
        with open(os.path.join(folder, "summary.json")) as f:
            assert np.isfinite(json.load(f)["foreground_mean"]["Dice"])
    ens = str(tmp_path / "ensemble")
    cli.ensemble_entry(["-i", pred01, pred0, "-o", ens, "--save_npz", "-np", "1"])
    for case in ("test_0", "test_1"):
        assert set(np.unique(_read_seg(os.path.join(ens, case + ".nii.gz")))) <= {0, 1, 2}
        with np.load(os.path.join(ens, case + ".npz")) as z:
            assert np.isfinite(z["probabilities"]).all()

    cli.find_best_configuration_entry(["965", "-c", "3d_fullres", "-tr", tr, "-f", "0", "1",
                                       "-np", "1"])
    with open(os.path.join(dirs["results"], DATASET, "inference_information.json")) as f:
        best = json.load(f)["best_model_or_ensemble"]
    assert best["configuration"] == "3d_fullres" and not best["ensemble"]
    merged = os.path.join(dirs["results"], DATASET,
                          f"crossval_results_{tr}__ATKPlans__3d_fullres")
    cli.apply_postprocessing_entry(["-i", ens, "-o", str(tmp_path / "ens_pp"), "-pp_file",
                                    os.path.join(merged, "postprocessing.json"), "-djfile",
                                    os.path.join(pred0, "dataset.json")])
    assert sorted(f for f in os.listdir(str(tmp_path / "ens_pp")) if f.endswith(".nii.gz")) == [
        "test_0.nii.gz", "test_1.nii.gz"]
    cli.accumulate_crossval_entry(["965", "-tr", tr, "-f", "0", "1"])
    assert os.path.isfile(model + "_crossval_results/summary.json")


def test_cli_pretrain_then_finetune(planned, tmp_path, monkeypatch):
    dirs, _ = _copy_planned(planned, tmp_path, monkeypatch)
    cli.pretrain_entry(["965", "-model", "S", "-patch_size", "16", "16", "16", "-batch_size", "2",
                        "-epochs", "1", "-iters_per_epoch", "1", "-compute_dtype", "float32",
                        "-device", "cpu"])
    ckpt = os.path.join(dirs["results"], DATASET, "pretrain_anatomask_S", "checkpoint_final.pt")
    assert os.path.isfile(ckpt)

    tr = "STUNetTrainer_small"
    monkeypatch.setitem(trainer_mod.TRAINER_PRESETS, tr,
                        replace(trainer_mod.TRAINER_PRESETS[tr], num_epochs=1))
    from anatomask_torch.ssl import pretrain as pretrain_mod
    loaded = {}
    load = pretrain_mod.load_ssl_encoder_into_trainer

    def spy(trainer, checkpoint, verbose=True):
        load(trainer, checkpoint, verbose)
        loaded.update({k: v.clone() for k, v in trainer.network.state_dict().items()})

    monkeypatch.setattr(pretrain_mod, "load_ssl_encoder_into_trainer", spy)
    cli.train_entry(["965", "3d_fullres", "0", "-tr", tr, "-pretrained_weights", ckpt,
                     "-device", "cpu"])
    state, _ = pretrain_mod.ckpt_lib.load_trainer_checkpoint(ckpt)
    encoder = {pretrain_mod.ckpt_lib.encoder_key(k): v
               for k, v in state["network_weights"].items() if "conv_blocks_context" in k}
    assert encoder and loaded
    for k, v in encoder.items():
        assert torch.equal(loaded[k], v.to(loaded[k].dtype)), k
    assert os.path.isfile(os.path.join(dirs["results"], DATASET, f"{tr}__ATKPlans__3d_fullres",
                                       "fold_0", "checkpoint_final.npz"))


@pytest.mark.parametrize("tr,jax_name", [("STUNetTrainer_small", "STUNetTrainer_S"),
                                         ("STUNetTrainer_base_ft", "STUNetTrainer_B")])
def test_train_folder_named_after_tr_unlike_jax(tr, jax_name, planned, tmp_path, monkeypatch):
    """Both CLIs' train on the same plans and -tr, with the training itself
    stubbed: the folder each trainer writes, and the trainer_name its
    checkpoints would carry (cfg.name). JAX trains a STUNet preset into the
    preset's own name, which its predict (`{-tr}__{plans}__{configuration}`)
    does not read; the port names both after -tr."""
    dirs, _ = _copy_planned(planned, tmp_path, monkeypatch)
    monkeypatch.setenv("ATK_COMPILE_CACHE", "")  # the JAX CLI writes no cache folder
    jcli = importlib.import_module("anatomask_tpu.cli")
    from anatomask_tpu.training import trainer as jtrainer_mod
    seen = {}
    for side, mod in (("jax", jtrainer_mod), ("port", trainer_mod)):
        def run_training(self, continue_training=False, side=side):
            seen[side] = (os.path.basename(self.output_folder_base), self.cfg.name,
                          os.path.isdir(self.output_folder))
        monkeypatch.setattr(mod.Trainer, "run_training", run_training)
        monkeypatch.setattr(mod.Trainer, "perform_actual_validation",
                            lambda self, save_probabilities=False: None)
    argv = ["965", "3d_fullres", "0", "-tr", tr]
    jcli.train_entry(argv)
    cli.train_entry(argv + ["-device", "cpu"])
    assert seen["jax"] == (f"{jax_name}__ATKPlans__3d_fullres", jax_name, True)
    assert seen["port"] == (f"{tr}__ATKPlans__3d_fullres", tr, True)


def test_train_in_two_gloo_ranks(planned, tmp_path, monkeypatch, capfd):
    """-num_gpus 2 -device cpu: two spawned gloo ranks train fold all, rank 0
    writes the checkpoints (best, then final; no leftover latest), each validation case is predicted
    once (rank r the keys [r::2]), and rank 0 writes summary.json."""
    dirs, _ = _copy_planned(planned, tmp_path, monkeypatch)
    tr = "ATKTrainer_1epoch"
    cli.train_entry(["965", "3d_fullres", "all", "-tr", tr, "-device", "cpu", "-num_gpus", "2"])
    fold = os.path.join(dirs["results"], DATASET, f"{tr}__ATKPlans__3d_fullres", "fold_all")
    assert sorted(f for f in os.listdir(fold) if f.startswith("checkpoint")) == [
        "checkpoint_best.npz", "checkpoint_final.npz"]
    keys = sorted(f[:-4] for f in os.listdir(os.path.join(
        dirs["preprocessed"], DATASET, "ATKPlans_3d_fullres")) if f.endswith(".npz")
        and not f.endswith(".props.npz"))
    lines = [ln for ln in capfd.readouterr().out.splitlines() if "predicting" in ln]
    assert sorted(lines) == sorted(f"[validation] rank {i % 2}: predicting {k}"
                                   for i, k in enumerate(keys))
    validation = os.path.join(fold, "validation")
    assert sorted(f for f in os.listdir(validation) if f.endswith(".nii.gz")) == [
        k + ".nii.gz" for k in keys]
    with open(os.path.join(validation, "summary.json")) as f:
        summary = json.load(f)
    assert np.isfinite(summary["foreground_mean"]["Dice"])
    # rank 0's metrics read rank 1's predictions too (after the barrier)
    assert sorted(os.path.basename(c["prediction_file"]) for c in summary["metric_per_case"]) == [
        k + ".nii.gz" for k in keys]

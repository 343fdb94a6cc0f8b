"""Command-line entry points of the port, registered as `atk_torch_<name>`
beside the JAX package's `atk_<name>` (anatomask_tpu/cli.py): the same
argument names and defaults, the same calls on the port's modules.

What differs from the JAX entries:
- `train`, `pretrain` and `predict` take `-device` (default `cuda`); without
  a CUDA device they raise unless given `-device cpu`, where every kernel's
  plain PyTorch version runs;
- `-num_gpus` above 1 raises NotImplementedError: the port runs on one GPU;
- `predict -compute_dtype` maps to torch.bfloat16 / torch.float32.

The dataset converters (`convert_msd`, `convert_challenge`) and
`plot_overlay_pngs` have no entry here yet.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from anatomask_torch.plans.plans_handler import load_json


def _verify_integrity(dataset_name_or_id, num_processes: int) -> None:
    from anatomask_torch.paths import require
    from anatomask_torch.planning.verify_integrity import verify_dataset_integrity
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    errs = verify_dataset_integrity(
        os.path.join(require("raw"), maybe_convert_to_dataset_name(dataset_name_or_id)),
        num_processes)
    if errs:
        raise RuntimeError(f"dataset {dataset_name_or_id} failed integrity check")


def _one_gpu(num_gpus: Optional[int]) -> None:
    if num_gpus is not None and num_gpus > 1:
        raise NotImplementedError(
            f"-num_gpus {num_gpus}: anatomask_torch runs on one GPU; multi-GPU training is "
            f"not ported yet (ROADMAP.md, open items 1, queue item 3: Multi-GPU)")


def _device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("-device", default="cuda",
                   help="torch device; 'cpu' runs every kernel's plain PyTorch version")


# --- planning / preprocessing -------------------------------------------------

def extract_fingerprint_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_extract_fingerprint")
    p.add_argument("-d", nargs="+", required=True, help="dataset name(s) or id(s)")
    p.add_argument("-np", type=int, default=8)
    p.add_argument("--verify_dataset_integrity", action="store_true")
    a = p.parse_args(argv)
    from anatomask_torch.planning.fingerprint import DatasetFingerprintExtractor
    for d in a.d:
        if a.verify_dataset_integrity:
            _verify_integrity(d, a.np)
        DatasetFingerprintExtractor(d, a.np).run(overwrite_existing=True)


def plan_experiment_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_plan_experiment")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-gpu_memory_target", type=float, default=8.0)
    p.add_argument("-overwrite_plans_name", default="ATKPlans")
    p.add_argument("-overwrite_target_spacing", nargs="+", type=float, default=None)
    a = p.parse_args(argv)
    from anatomask_torch.planning.planner import ExperimentPlanner
    for d in a.d:
        ExperimentPlanner(
            d, memory_target_gb=a.gpu_memory_target, plans_name=a.overwrite_plans_name,
            overwrite_target_spacing=a.overwrite_target_spacing,
        ).plan_experiment()


def preprocess_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_preprocess")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    p.add_argument("-plans_name", default="ATKPlans")
    p.add_argument("-np", type=int, default=8)
    a = p.parse_args(argv)
    from anatomask_torch.paths import require
    from anatomask_torch.preprocessing.preprocessor import DefaultPreprocessor
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    for d in a.d:
        name = maybe_convert_to_dataset_name(d)
        plans = load_json(os.path.join(require("preprocessed"), name, a.plans_name + ".json"))
        for c in a.c:
            if c not in plans["configurations"]:
                print(f"skipping {c} (not in plans)")
                continue
            DefaultPreprocessor().run(d, c, a.plans_name, a.np)


def plan_and_preprocess_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_plan_and_preprocess")
    p.add_argument("-d", nargs="+", required=True)
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"])
    p.add_argument("-plans_name", default="ATKPlans")
    p.add_argument("-np", type=int, default=8)
    p.add_argument("-gpu_memory_target", type=float, default=8.0)
    p.add_argument("--verify_dataset_integrity", action="store_true")
    p.add_argument("--no_pp", action="store_true", help="plan only, skip preprocessing")
    a = p.parse_args(argv)
    from anatomask_torch.planning.planner import plan_and_preprocess
    for d in a.d:
        if a.verify_dataset_integrity:
            _verify_integrity(d, a.np)
        plan_and_preprocess(
            d, configurations=() if a.no_pp else tuple(a.c), plans_name=a.plans_name,
            num_processes=a.np, memory_target_gb=a.gpu_memory_target, overwrite=True,
        )


# --- training ----------------------------------------------------------------

def train_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_train")
    p.add_argument("dataset_name_or_id")
    p.add_argument("configuration")
    p.add_argument("fold", help="0-4 or 'all'")
    p.add_argument("-tr", default="ATKTrainer")
    p.add_argument("-p", default="ATKPlans")
    p.add_argument("-pretrained_weights", default=None,
                   help="pretraining checkpoint whose encoder is transferred in")
    p.add_argument("--c", action="store_true", dest="continue_training")
    p.add_argument("--val", action="store_true", help="only run final validation")
    p.add_argument("--val_best", action="store_true")
    p.add_argument("--npz", action="store_true", help="save softmax probabilities")
    p.add_argument("--disable_checkpointing", action="store_true")
    p.add_argument("-num_gpus", type=int, default=None,
                   help="number of GPUs (the port runs on one)")
    _device_argument(p)
    a = p.parse_args(argv)
    _one_gpu(a.num_gpus)
    from anatomask_torch.device import resolve_device
    resolve_device(a.device)

    from dataclasses import replace

    from anatomask_torch.paths import require
    from anatomask_torch.training.trainer import Trainer, get_trainer_config
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    name = maybe_convert_to_dataset_name(a.dataset_name_or_id)
    pp = os.path.join(require("preprocessed"), name)
    dataset_json = load_json(os.path.join(pp, "dataset.json"))
    # the output folder is named after -tr, where predict, export and
    # find_best_configuration look for it (a preset's own name may differ)
    cfg = replace(get_trainer_config(a.tr), name=a.tr)
    fold = a.fold if a.fold == "all" else int(a.fold)
    trainer = Trainer(os.path.join(pp, a.p + ".json"), a.configuration, fold, dataset_json, cfg,
                      device=a.device)
    trainer.disable_checkpointing = a.disable_checkpointing
    if a.val or a.val_best:
        trainer.initialize()
        trainer.load_checkpoint("checkpoint_best.npz" if a.val_best else "checkpoint_final.npz")
        trainer.perform_actual_validation(save_probabilities=a.npz)
        return
    if a.pretrained_weights:
        trainer.initialize()
        from anatomask_torch.ssl.pretrain import load_ssl_encoder_into_trainer
        load_ssl_encoder_into_trainer(trainer, a.pretrained_weights)
    trainer.run_training(continue_training=a.continue_training)
    trainer.perform_actual_validation(save_probabilities=a.npz)


def pretrain_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_pretrain")
    p.add_argument("dataset_name_or_id")
    p.add_argument("-method", choices=["spark", "anatomask"], default="anatomask")
    p.add_argument("-model", choices=["S", "B", "L", "H"], default="B")
    p.add_argument("-patch_size", nargs=3, type=int, default=[112, 112, 128])
    p.add_argument("-batch_size", type=int, default=4)
    p.add_argument("-mask_ratio", type=float, default=0.6)
    p.add_argument("-epochs", type=int, default=1000)
    p.add_argument("-iters_per_epoch", type=int, default=None)
    p.add_argument("-compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-p", default="ATKPlans")
    p.add_argument("-c", dest="configuration", default="3d_fullres")
    p.add_argument("-fold", type=int, default=0)
    p.add_argument("--no_guide", action="store_true", help="disable easy-to-hard curriculum")
    p.add_argument("--continue", action="store_true", dest="continue_training")
    p.add_argument("-grad_accum", type=int, default=2,
                   help="microbatches a step, gradients summed (exact for per-sample norms)")
    p.add_argument("-num_gpus", type=int, default=None,
                   help="number of GPUs (the port runs on one)")
    _device_argument(p)
    a = p.parse_args(argv)
    _one_gpu(a.num_gpus)
    from anatomask_torch.device import resolve_device
    resolve_device(a.device)
    from anatomask_torch.ssl.pretrain import PretrainConfig, PretrainTrainer
    lr = a.lr if a.lr is not None else (2e-4 if a.method == "spark" else 1e-4)
    cfg = PretrainConfig(
        method=a.method, model_size=a.model, patch_size=tuple(a.patch_size),
        batch_size=a.batch_size, mask_ratio=a.mask_ratio, num_epochs=a.epochs,
        iters_per_epoch=a.iters_per_epoch, compute_dtype=a.compute_dtype,
        lr=lr, guide=not a.no_guide, grad_accum_steps=a.grad_accum,
    )
    PretrainTrainer(a.dataset_name_or_id, cfg, a.p, a.configuration, a.fold,
                    device=a.device).run_pretraining(continue_training=a.continue_training)


# --- inference ---------------------------------------------------------------

def predict_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_predict")
    p.add_argument("-i", required=True, help="input folder")
    p.add_argument("-o", required=True, help="output folder")
    p.add_argument("-d", required=True, help="dataset name or id")
    p.add_argument("-c", required=True, help="configuration")
    p.add_argument("-tr", default="ATKTrainer")
    p.add_argument("-p", default="ATKPlans")
    p.add_argument("-f", nargs="+", default=None, help="folds")
    p.add_argument("-chk", default="checkpoint_final.npz")
    p.add_argument("-step_size", type=float, default=0.5)
    p.add_argument("--disable_tta", action="store_true")
    p.add_argument("--save_probabilities", action="store_true")
    p.add_argument("--continue_prediction", action="store_true")
    p.add_argument("-num_parts", type=int, default=1)
    p.add_argument("-part_id", type=int, default=0)
    p.add_argument("-prev_stage_predictions", default=None)
    p.add_argument("-compute_dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="tile compute dtype; the Gaussian accumulation is fp32")
    _device_argument(p)
    a = p.parse_args(argv)
    from anatomask_torch.device import resolve_device
    resolve_device(a.device)

    import torch

    from anatomask_torch.inference.predictor import Predictor
    from anatomask_torch.paths import require
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    name = maybe_convert_to_dataset_name(a.d)
    model_dir = os.path.join(require("results"), name, f"{a.tr}__{a.p}__{a.c}")
    predictor = Predictor(tile_step_size=a.step_size, use_mirroring=not a.disable_tta,
                          dtype=torch.bfloat16 if a.compute_dtype == "bfloat16"
                          else torch.float32, device=a.device)
    folds = None if a.f is None else [f if f == "all" else int(f) for f in a.f]
    predictor.initialize_from_trained_model_folder(model_dir, folds, a.chk)
    predictor.predict_from_files(
        a.i, a.o, save_probabilities=a.save_probabilities,
        overwrite=not a.continue_prediction,
        folder_with_segs_from_prev_stage=a.prev_stage_predictions,
        num_parts=a.num_parts, part_id=a.part_id,
    )


# --- evaluation / ensembling / selection -------------------------------------

def _label_manager(dataset_json: dict):
    from anatomask_torch.plans.label_handling import LabelManager
    lm = LabelManager(dataset_json["labels"], dataset_json.get("regions_class_order"))
    return lm, lm.foreground_regions if lm.has_regions else lm.foreground_labels


def evaluate_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_evaluate")
    p.add_argument("gt_folder")
    p.add_argument("pred_folder")
    p.add_argument("-djfile", default=None, help="dataset.json path")
    p.add_argument("-o", default=None, help="output summary.json")
    p.add_argument("-np", type=int, default=4)
    a = p.parse_args(argv)
    from anatomask_torch.evaluation.metrics import compute_metrics_on_folder
    from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
    djfile = a.djfile or os.path.join(a.pred_folder, "dataset.json")
    dataset_json = load_json(djfile)
    lm, labels_or_regions = _label_manager(dataset_json)
    rw = determine_reader_writer_from_dataset_json(dataset_json)()
    out = a.o or os.path.join(a.pred_folder, "summary.json")
    m = compute_metrics_on_folder(a.gt_folder, a.pred_folder, out, rw,
                                  dataset_json["file_ending"], labels_or_regions,
                                  lm.ignore_label, a.np)
    print("foreground mean Dice:", m["foreground_mean"]["Dice"])


def ensemble_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_ensemble")
    p.add_argument("-i", nargs="+", required=True, help="input folders with .npz probabilities")
    p.add_argument("-o", required=True)
    p.add_argument("-np", type=int, default=4)
    p.add_argument("--save_npz", action="store_true")
    a = p.parse_args(argv)
    from anatomask_torch.ensembling.ensemble import ensemble_folders
    ensemble_folders(a.i, a.o, a.save_npz, a.np)


def find_best_configuration_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_find_best_configuration")
    p.add_argument("dataset_name_or_id")
    p.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres", "3d_cascade_fullres"])
    p.add_argument("-tr", nargs="+", default=["ATKTrainer"])
    p.add_argument("-p", nargs="+", default=["ATKPlans"])
    p.add_argument("-f", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("--disable_ensembling", action="store_true")
    p.add_argument("-np", type=int, default=4)
    a = p.parse_args(argv)
    from anatomask_torch.evaluation.find_best_configuration import find_best_configuration
    find_best_configuration(
        a.dataset_name_or_id, a.c, a.tr, a.p, a.f,
        allow_ensembling=not a.disable_ensembling, num_processes=a.np,
    )


# --- postprocessing ----------------------------------------------------------

def determine_postprocessing_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_determine_postprocessing")
    p.add_argument("-i", required=True, help="predictions folder")
    p.add_argument("-ref", required=True, help="ground-truth folder")
    p.add_argument("-djfile", required=True)
    p.add_argument("-np", type=int, default=4)
    a = p.parse_args(argv)
    from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
    from anatomask_torch.postprocessing.components import determine_postprocessing
    dataset_json = load_json(a.djfile)
    lm, labels_or_regions = _label_manager(dataset_json)
    determine_postprocessing(
        a.i, a.ref, determine_reader_writer_from_dataset_json(dataset_json)(),
        dataset_json["file_ending"], labels_or_regions, lm.ignore_label, num_processes=a.np,
    )


def apply_postprocessing_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_apply_postprocessing")
    p.add_argument("-i", required=True)
    p.add_argument("-o", required=True)
    p.add_argument("-pp_file", required=True, help="postprocessing.json")
    p.add_argument("-djfile", required=True)
    p.add_argument("-np", type=int, default=4)
    a = p.parse_args(argv)
    from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
    from anatomask_torch.postprocessing.components import (apply_postprocessing_to_folder,
                                                           load_postprocessing_description)
    dataset_json = load_json(a.djfile)
    apply_postprocessing_to_folder(
        a.i, a.o, load_postprocessing_description(a.pp_file),
        determine_reader_writer_from_dataset_json(dataset_json)(),
        dataset_json["file_ending"], a.np,
    )


# --- model sharing / plans ---------------------------------------------------

def export_model_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_export_model")
    p.add_argument("dataset_name_or_id")
    p.add_argument("-o", required=True, help="output zip")
    p.add_argument("-tr", default="ATKTrainer")
    p.add_argument("-p", default="ATKPlans")
    p.add_argument("-c", nargs="+", default=["3d_fullres"])
    p.add_argument("-f", nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--not_strict", action="store_true")
    a = p.parse_args(argv)
    from anatomask_torch.utils.model_sharing import export_pretrained_model
    export_pretrained_model(a.dataset_name_or_id, a.o, a.tr, a.p, a.c, a.f,
                            strict=not a.not_strict)


def install_model_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_install_model")
    p.add_argument("-i", required=True, help="model zip file")
    a = p.parse_args(argv)
    from anatomask_torch.utils.model_sharing import install_model_from_zip_file
    install_model_from_zip_file(a.i)


def move_plans_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_move_plans_between_datasets")
    p.add_argument("-s", required=True, help="source dataset (plans origin)")
    p.add_argument("-t", required=True, help="target dataset")
    p.add_argument("-sp", default="ATKPlans")
    p.add_argument("-tp", default=None)
    a = p.parse_args(argv)
    from anatomask_torch.planning.move_plans import move_plans_between_datasets
    move_plans_between_datasets(a.s, a.t, a.sp, a.tp)


def accumulate_crossval_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_accumulate_crossval_results")
    p.add_argument("dataset_name_or_id")
    p.add_argument("-c", default="3d_fullres")
    p.add_argument("-tr", default="ATKTrainer")
    p.add_argument("-p", default="ATKPlans")
    p.add_argument("-f", nargs="+", type=int, default=[0, 1, 2, 3, 4])
    p.add_argument("-o", default=None)
    a = p.parse_args(argv)
    from anatomask_torch.evaluation.find_best_configuration import (accumulate_cv_results,
                                                                    folder_for_model)
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    name = maybe_convert_to_dataset_name(a.dataset_name_or_id)
    model = folder_for_model(name, a.tr, a.p, a.c)
    m = accumulate_cv_results(model, a.o or (model + "_crossval_results"), a.f)
    print("foreground mean Dice:", m["foreground_mean"]["Dice"])


def download_model_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_download_model")
    p.add_argument("-url", required=True)
    a = p.parse_args(argv)
    import tempfile
    import urllib.request

    from anatomask_torch.utils.model_sharing import install_model_from_zip_file
    with tempfile.NamedTemporaryFile(suffix=".zip", delete=False) as f:
        print(f"downloading {a.url} ...")
        urllib.request.urlretrieve(a.url, f.name)
        install_model_from_zip_file(f.name)

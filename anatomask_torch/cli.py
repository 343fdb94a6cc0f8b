"""Command-line entry points of the port, registered as `atk_torch_<name>`
beside the JAX package's `atk_<name>` (anatomask_tpu/cli.py): the same
argument names and defaults, the same calls on the port's modules.

What differs from the JAX entries:
- `train`, `pretrain` and `predict` take `-device` (default `cuda`); without
  a CUDA device they raise unless given `-device cpu`, where every kernel's
  plain PyTorch version runs;
- `train` and `pretrain` run as many ranks as JAX's mesh has devices: every
  visible card, capped by `-num_gpus` or ATK_NUM_DEVICES (a cap above the
  visible cards raises). Above one, the entry's body runs in that many
  spawned processes of one group (`parallel/mesh.py` `launch`): NCCL, a card
  each; with `-device cpu`, gloo ranks on the CPU;
- on several nodes, the counterpart of the JAX entries' multi-host start:
  PyTorch's launcher starts one process a rank on every node,

      torchrun --nnodes 2 --nproc_per_node 8 --node_rank K --master_addr HOST \
          --master_port PORT -m anatomask_torch.cli train 950 3d_fullres 0

  and each joins the group its variables describe (`mesh.run_joined`) and
  runs the entry's body as that rank, on its node's card LOCAL_RANK (NCCL;
  gloo with `-device cpu` or a device that names one card, which the
  node's ranks then share). It never spawns; `-num_gpus`, if given, must be
  the launcher's WORLD_SIZE. A partial set of the launcher's variables or a
  failed join raises (JAX carries on in one process);
- `predict -compute_dtype` maps to torch.bfloat16 / torch.float32;
  `-compute_dtype float32` (`train`'s trainers, `pretrain`, `predict`)
  also turns TF32 off for cuDNN and cuBLAS (`device.compute_dtype`), which
  PyTorch would otherwise use for a float32 convolution.
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


def _run_ranks(body, a: argparse.Namespace) -> None:
    """body(a) as this process's rank of the launcher's group where its
    variables are set, else in this process at one rank, else in `launch`'s
    ranks."""
    from anatomask_torch.device import resolve_device
    from anatomask_torch.parallel import mesh
    world = mesh.world_size_for(a.device, a.num_gpus)
    resolve_device(a.device)
    if mesh.launcher_env() is not None:
        mesh.run_joined(body, a.device, a)
    elif world == 1:
        body(a)
    else:
        mesh.launch(body, world, a.device, a)


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
                   help="ranks, one a card (default: every visible card; with -device cpu, "
                        "gloo ranks, default 1; under torchrun: its WORLD_SIZE, which a "
                        "given value must equal)")
    _device_argument(p)
    _run_ranks(_train, p.parse_args(argv))


def _train(a: argparse.Namespace) -> None:
    from dataclasses import replace

    from anatomask_torch.parallel.mesh import rank_device
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
                      device=rank_device(a.device))
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
                   help="ranks, one a card (default: every visible card; with -device cpu, "
                        "gloo ranks, default 1; under torchrun: its WORLD_SIZE, which a "
                        "given value must equal)")
    _device_argument(p)
    _run_ranks(_pretrain, p.parse_args(argv))


def _pretrain(a: argparse.Namespace) -> None:
    from anatomask_torch.parallel.mesh import rank_device
    from anatomask_torch.ssl.pretrain import PretrainConfig, PretrainTrainer
    lr = a.lr if a.lr is not None else (2e-4 if a.method == "spark" else 1e-4)
    cfg = PretrainConfig(
        method=a.method, model_size=a.model, patch_size=tuple(a.patch_size),
        batch_size=a.batch_size, mask_ratio=a.mask_ratio, num_epochs=a.epochs,
        iters_per_epoch=a.iters_per_epoch, compute_dtype=a.compute_dtype,
        lr=lr, guide=not a.no_guide, grad_accum_steps=a.grad_accum,
    )
    trainer = PretrainTrainer(a.dataset_name_or_id, cfg, a.p, a.configuration, a.fold,
                              device=rank_device(a.device))
    trainer.run_pretraining(continue_training=a.continue_training)


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


def convert_msd_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_convert_msd")
    p.add_argument("-i", required=True, help="MSD TaskXX_Name folder")
    p.add_argument("-overwrite_id", type=int, default=None)
    p.add_argument("-np", type=int, default=4)
    a = p.parse_args(argv)
    from anatomask_torch.dataset_conversion.convert_msd import convert_msd_dataset
    convert_msd_dataset(a.i, a.overwrite_id, a.np)


def convert_challenge_entry(argv: Optional[List[str]] = None):
    """Challenge dataset converters (nnU-Net's Dataset*_*.py scripts)."""
    p = argparse.ArgumentParser("atk_torch_convert_challenge")
    sub = p.add_subparsers(dest="task", required=True)
    for task, default_id in (("kits23", 220), ("amos1", 218), ("amos2", 219),
                             ("autopet", 221), ("emidec", 115),
                             ("fluo_c3dh", 73), ("roads", 120)):
        sp = sub.add_parser(task)
        sp.add_argument("input_folder")
        sp.add_argument("-d", type=int, default=default_id)
        if task in ("emidec", "fluo_c3dh"):
            sp.add_argument("-t", dest="test_dir", default=None)
    sp = sub.add_parser("mnms")
    sp.add_argument("input_folder")
    sp.add_argument("-csv", default="211230_M&Ms_Dataset_information_diagnosis_opendataset.csv")
    sp.add_argument("-d", type=int, default=114)
    sp.add_argument("--custom_splits", action="store_true",
                    help="append vendor-stratified custom splits (run after "
                         "plan+preprocess created splits_final.json)")
    sp = sub.add_parser("old_nnunet")
    sp.add_argument("input_folder")
    sp.add_argument("output_dataset_name")
    sp = sub.add_parser("acdc")
    sp.add_argument("input_folder")
    sp.add_argument("-d", type=int, default=27)
    sp = sub.add_parser("brats_regions")
    sp.add_argument("input_folder")
    sp.add_argument("-d", type=int, default=137)
    sp.add_argument("--no_regions", action="store_true",
                    help="plain 3-class labels instead of BraTS regions")
    sp = sub.add_parser("brats_convert_back",
                        help="convert predictions back to the BraTS labeling "
                             "convention for submission")
    sp.add_argument("input_folder")
    sp.add_argument("output_folder")
    a = p.parse_args(argv)
    from anatomask_torch.dataset_conversion import convert_challenges as cc
    from anatomask_torch.dataset_conversion.convert_acdc import convert_acdc_dataset
    from anatomask_torch.dataset_conversion.convert_brats import (convert_brats_dataset,
                                                                  convert_folder_back_to_brats)
    calls = {
        "kits23": lambda: cc.convert_kits2023(a.input_folder, a.d),
        "amos1": lambda: cc.convert_amos_task1(a.input_folder, a.d),
        "amos2": lambda: cc.convert_amos_task2(a.input_folder, a.d),
        "autopet": lambda: cc.convert_autopet(a.input_folder, a.d),
        "emidec": lambda: cc.convert_emidec(a.input_folder, a.test_dir, a.d),
        "fluo_c3dh": lambda: cc.convert_fluo_c3dh_a549_sim(a.input_folder, a.test_dir, a.d),
        "roads": lambda: cc.convert_road_segmentation(a.input_folder, a.d),
        "mnms": lambda: (cc.create_mnms_custom_splits if a.custom_splits
                         else cc.convert_mnms)(a.input_folder, a.csv, a.d),
        "old_nnunet": lambda: cc.convert_old_nnunet_dataset(a.input_folder,
                                                            a.output_dataset_name),
        "acdc": lambda: convert_acdc_dataset(a.input_folder, a.d),
        "brats_regions": lambda: convert_brats_dataset(a.input_folder, a.d,
                                                       use_regions=not a.no_regions),
        "brats_convert_back": lambda: convert_folder_back_to_brats(a.input_folder,
                                                                   a.output_folder),
    }
    calls[a.task]()


def plot_overlay_pngs_entry(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser("atk_torch_plot_overlay_pngs")
    p.add_argument("-i", required=True, help="images folder")
    p.add_argument("-s", required=True, help="segmentations folder")
    p.add_argument("-o", required=True, help="output folder")
    p.add_argument("-djfile", required=True)
    p.add_argument("-np", type=int, default=4)
    a = p.parse_args(argv)
    from anatomask_torch.utils.overlay_plots import generate_overlays_for_folder
    generate_overlays_for_folder(a.i, a.s, a.o, load_json(a.djfile), a.np)


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


def main(argv: Optional[List[str]] = None):
    """`python -m anatomask_torch.cli <name> <arguments>`: the entry
    `<name>_entry`, e.g. under torchrun, which starts a module or a script
    and not a console script."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    names = sorted(k[:-len("_entry")] for k in globals() if k.endswith("_entry"))
    if not argv or argv[0] not in names:
        raise SystemExit(f"usage: python -m anatomask_torch.cli {{{','.join(names)}}} ...")
    return globals()[f"{argv[0]}_entry"](argv[1:])


if __name__ == "__main__":
    main()

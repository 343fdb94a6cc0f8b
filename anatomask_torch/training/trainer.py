"""Supervised trainer on one GPU. Counterpart of
anatomask_tpu/training/trainer.py (nnU-Net's trainer and its STUNet
finetuning recipe):

- lifecycle `initialize` -> `run_training` (epochs of
  num_iterations_per_epoch training and num_val_iterations_per_epoch
  validation steps) -> `perform_actual_validation`; checkpoints latest /
  best (EMA pseudo-Dice) / final, resume;
- the 5-fold split with seed 12345 (splits_final.json);
- DC + CE (or the configured loss) with 1/2^i deep-supervision weights;
  global-norm clip 12, then SGD-Nesterov 0.99 + poly LR, or AdamW / Adam /
  Adan (optax's laws) + cosine, the LR set per step from the epoch;
- on-device augmentation of each batch (`data/augment.py`, with DA5's extras
  for ATKTrainerDA5), from the GPU case cache (default) or the host pipeline;
- the final validation: the sliding-window Predictor, export, summary.json,
  and for a stage with a next stage its resampled logits
  (`predicted_next_stage`);
- cascade stages (a configuration with `previous_stage`, e.g.
  3d_cascade_fullres): the previous stage's predictions stacked under the
  labels, corrupted per training patch and one-hot into the input, on the
  host pipeline.

On one device JAX's mesh reduces to it: the global batch is the plans'
batch. Under a process group (`parallel/mesh.py`; `atk_torch_train -num_gpus
N`), one rank a card, as JAX's multi-host run: the plans' batch scaled up to
a multiple of the ranks is the global batch, each rank samples its share
(its oversample fraction, seed + 131071 * rank) through the host pipeline,
augments it with its rows of the global batch's draws, and its gradients are
averaged over the ranks before the clip (the losses and BatchNorm take the
global batch's statistics: training/losses.py, models/layers.py); the
validation step's loss and counts are summed over the ranks; rank 0 alone
unpacks, writes the split, logs and checkpoints; the final validation
predicts `val_keys[rank::world]` on each rank and rank 0 computes the metrics
after a barrier. The network computes in the compute dtype (bf16 by default)
with fp32 weights; augmentation runs in fp32 and the batch is cast before the
forward, as in the JAX step. Checkpoints are `checkpoint_{latest,best,final}.npz` in the JAX
package's layout (`convert.state_dict_to_jax`, its metadata keys), so both
packages' predictors read them; the torch optimizer's state rides along under
`torch_optimizer_state` (arrays) and `torch_optimizer_param_groups`
(metadata), which the JAX trainer does not read. A JAX checkpoint resumes
here with a fresh optimizer state, as a JAX one of another structure does
there. `remat` checkpoints activations as the JAX models place it (STUNet-H
always). The cascade's final validation predicts the data with the previous
stage's one-hot stacked, as nnU-Net does; the JAX trainer predicts the data
alone, which its cascade network refuses (ROADMAP.md §3 item 7).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from anatomask_torch.configuration import get_allowed_n_proc_DA
from anatomask_torch.convert import state_dict_from_jax, state_dict_to_jax
from anatomask_torch.data.augment import (AugmentConfig, IntensityAugmentConfig,
                                          SpatialAugmentConfig, make_train_augment_fn,
                                          make_val_transform_fn,
                                          rotation_ranges_and_initial_patch_size)
from anatomask_torch.data.augment_da5 import DA5Config
from anatomask_torch.data.dataset import CaseDataset, unpack_dataset
from anatomask_torch.data.pipeline import PrefetchPipeline
from anatomask_torch.data.sampler import PatchSampler
from anatomask_torch.device import compute_dtype, resolve_device
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.models.layers import BatchNorm
from anatomask_torch.parallel import mesh
from anatomask_torch.paths import require
from anatomask_torch.plans.label_handling import (convert_labelmap_to_one_hot,
                                                  determine_num_input_channels)
from anatomask_torch.plans.plans_handler import (ConfigurationManager, PlansManager, load_json,
                                                 save_json)
from anatomask_torch.training import checkpoint as ckpt_lib
from anatomask_torch.training.logger import TrainingLogger
from anatomask_torch.training.losses import (cross_entropy_loss, dc_and_bce_loss,
                                             dc_and_ce_loss, dc_and_topk_loss,
                                             deep_supervision_loss, deep_supervision_weights,
                                             hard_dice_parts, memory_efficient_soft_dice_loss,
                                             region_targets)
from anatomask_torch.training.schedules import cosine_annealing_schedule, poly_lr_schedule


@dataclass(frozen=True)
class TrainerConfig:
    """The JAX package's TrainerConfig: the trainer variants are presets of
    it (TRAINER_PRESETS)."""
    name: str = "ATKTrainer"
    num_epochs: int = 1000
    num_iterations_per_epoch: int = 250
    num_val_iterations_per_epoch: int = 50
    optimizer: str = "sgd"                 # sgd | adamw | adam | adan
    initial_lr: float = 1e-2
    weight_decay: float = 3e-5
    adam_eps: float = 1e-8
    lr_scheduler: str = "poly"             # poly | cosine
    grad_clip: float = 12.0
    oversample_foreground_percent: float = 0.33
    probabilistic_oversampling: bool = False
    enable_deep_supervision: bool = True
    loss: str = "dc_ce"                    # dc_ce | dice | ce | dc_topk
    do_mirroring_aug: bool = True
    do_data_augmentation: bool = True
    save_every: int = 50
    arch_name: Optional[str] = None        # e.g. "STUNet-B"
    compute_dtype: str = "bfloat16"
    benchmark: bool = False                # write benchmark_result.json
    benchmark_no_dataloading: bool = False # dummy batches held on the device
    num_workers: Optional[int] = None
    seed: int = 12345
    aggressive_da: bool = False            # DA5 (ATKTrainerDA5)
    order0_data_interp: bool = False       # nearest data warp
    data_interpolation_order: int = 1      # 1 trilinear, 3 cubic B-spline
    network_norm: str = "instance"         # instance | batch (PlainConvUNet)
    remat: bool = False                    # activation checkpointing (STUNet-H: always)
    # GPU-resident case cache; None = env ATK_SUP_DEVICE_CACHE (default on)
    device_cache: Optional[bool] = None
    device_cache_mb: int = 1024


def stunet_trainer_config(size: str = "B", **overrides) -> TrainerConfig:
    """The STUNetTrainer recipe: AdamW 1e-4, wd 1e-5, eps 1e-4, cosine."""
    base = TrainerConfig(
        name=f"STUNetTrainer_{size}",
        optimizer="adamw", initial_lr=1e-4, weight_decay=1e-5, adam_eps=1e-4,
        lr_scheduler="cosine", arch_name=f"STUNet-{size}",
    )
    return replace(base, **overrides)


def _epochs(n: int, mirroring: bool = True) -> Tuple[str, TrainerConfig]:
    name = f"ATKTrainer_{n}epoch{'s' if n > 1 else ''}{'' if mirroring else '_NoMirroring'}"
    return name, TrainerConfig(name=name, num_epochs=n, do_mirroring_aug=mirroring)


def _preset(name: str, **kw) -> Tuple[str, TrainerConfig]:
    return name, TrainerConfig(name=name, **kw)


TRAINER_PRESETS: Dict[str, TrainerConfig] = dict([
    ("ATKTrainer", TrainerConfig()),
    *[_epochs(n) for n in (1, 5, 10, 20, 50, 100, 250, 2000, 4000, 8000)],
    *[_epochs(n, mirroring=False) for n in (250, 2000, 4000, 8000)],
    _preset("ATKTrainerCosAnneal", lr_scheduler="cosine"),
    _preset("ATKTrainerAdam", optimizer="adam", initial_lr=3e-4),
    _preset("ATKTrainerAdamW", optimizer="adamw", initial_lr=3e-4),
    _preset("ATKTrainerAdan", optimizer="adan"),
    _preset("ATKTrainerAdan1en3", optimizer="adan", initial_lr=1e-3),
    _preset("ATKTrainerAdan3en4", optimizer="adan", initial_lr=3e-4),
    _preset("ATKTrainerAdan1en1", optimizer="adan", initial_lr=1e-1),
    _preset("ATKTrainerAdanCosAnneal", optimizer="adan", lr_scheduler="cosine"),
    _preset("ATKTrainerNoMirroring", do_mirroring_aug=False),
    _preset("ATKTrainerNoDA", do_data_augmentation=False),
    _preset("ATKTrainerNoDeepSupervision", enable_deep_supervision=False),
    _preset("ATKTrainerDiceLoss", loss="dice"),
    _preset("ATKTrainerCELoss", loss="ce"),
    _preset("ATKTrainerTopkLoss", loss="dc_topk"),
    _preset("ATKTrainer_probabilisticOversampling", probabilistic_oversampling=True),
    _preset("ATKTrainer_probabilisticOversampling_033", probabilistic_oversampling=True,
            oversample_foreground_percent=0.33),
    _preset("ATKTrainer_probabilisticOversampling_010", probabilistic_oversampling=True,
            oversample_foreground_percent=0.10),
    _preset("ATKTrainerBenchmark_5epochs", num_epochs=5, benchmark=True),
    _preset("ATKTrainerBenchmark_5epochs_noDataLoading", num_epochs=5, benchmark=True,
            benchmark_no_dataloading=True),
    _preset("ATKTrainerDA5", aggressive_da=True),
    _preset("ATKTrainerDAOrd0", order0_data_interp=True),
    _preset("ATKTrainerDataOrder3", data_interpolation_order=3),
    _preset("ATKTrainerBN", network_norm="batch"),
    ("STUNetTrainer_small", stunet_trainer_config("S")),
    ("STUNetTrainer_base", stunet_trainer_config("B")),
    ("STUNetTrainer_large", stunet_trainer_config("L")),
    ("STUNetTrainer_huge", stunet_trainer_config("H")),
    ("STUNetTrainer_base_ft", stunet_trainer_config("B")),
])


def get_trainer_config(name: str) -> TrainerConfig:
    if name not in TRAINER_PRESETS:
        raise RuntimeError(f"Unknown trainer {name!r}. Known: {sorted(TRAINER_PRESETS)}")
    return TRAINER_PRESETS[name]


def generate_crossval_split(keys: List[str], n_splits: int = 5, seed: int = 12345) -> List[dict]:
    """KFold(5, shuffle, seed 12345) as in nnU-Net's do_split."""
    keys = sorted(keys)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(keys))
    folds = np.array_split(idx, n_splits)
    splits = []
    for f in range(n_splits):
        val_idx = set(folds[f].tolist())
        splits.append({
            "train": [keys[i] for i in range(len(keys)) if i not in val_idx],
            "val": [keys[i] for i in sorted(val_idx)],
        })
    return splits


def promote_2d_configuration(cfg: dict) -> dict:
    """A 2D configuration dict as singleton-3D: patch (1, y, x), a leading 1
    on every stage's pool and kernel size."""
    out = dict(cfg)
    out["patch_size"] = [1, *cfg["patch_size"]]
    if "pool_op_kernel_sizes" in cfg:
        out["pool_op_kernel_sizes"] = [[1, *p] for p in cfg["pool_op_kernel_sizes"]]
    if "conv_kernel_sizes" in cfg:
        out["conv_kernel_sizes"] = [[1, *k] for k in cfg["conv_kernel_sizes"]]
    if "num_pool_per_axis" in cfg:
        out["num_pool_per_axis"] = [0, *cfg["num_pool_per_axis"]]
    if "median_image_size_in_voxels" in cfg and len(cfg["median_image_size_in_voxels"]) == 2:
        out["median_image_size_in_voxels"] = [1, *cfg["median_image_size_in_voxels"]]
    return out


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: where the global norm is >= max_norm, every
    gradient becomes g / norm * max_norm. (torch's clip_grad_norm_ adds 1e-6 to
    the norm.) Runs on the device without a host sync; returns the norm."""
    grads = list(grads)
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm


class Adan(torch.optim.Optimizer):
    """optax.adan (b1 0.98, b2 0.92, b3 0.99, eps 1e-8, eps_root 1e-8) with
    its decoupled weight decay on every parameter: u = (m^ + (1 - b2) v^) /
    (sqrt(n^ + eps_root) + eps) + wd * p; p -= lr * u. optax's b's are the
    moments' decays (m = (1 - b1) g + b1 m)."""

    def __init__(self, params, lr: float, b1: float = 0.98, b2: float = 0.92, b3: float = 0.99,
                 eps: float = 1e-8, eps_root: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, b3=b3, eps=eps, eps_root=eps_root,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2, b3 = group["b1"], group["b2"], group["b3"]
            for p in group["params"]:
                g = p.grad
                st = self.state[p]
                if not st:
                    for k in ("m", "v", "n", "g"):
                        st[k] = torch.zeros_like(p)
                    st["t"] = torch.zeros((), dtype=torch.int64)
                diff = g - st["g"] if int(st["t"]) > 0 else torch.zeros_like(g)
                st["m"].mul_(b1).add_(g, alpha=1 - b1)
                st["v"].mul_(b2).add_(diff, alpha=1 - b2)
                sq = g + (1 - b2) * diff
                st["n"].mul_(b3).add_(sq * sq, alpha=1 - b3)
                st["t"] += 1
                t = int(st["t"])
                m_hat = st["m"] / (1 - b1 ** t)
                v_hat = st["v"] / (1 - b2 ** t)
                n_hat = st["n"] / (1 - b3 ** t)
                u = (m_hat + (1 - b2) * v_hat) / (torch.sqrt(n_hat + group["eps_root"])
                                                  + group["eps"])
                p.sub_(group["lr"] * (u + group["weight_decay"] * p))
                st["g"].copy_(g)


class Trainer:
    def __init__(
        self,
        plans: dict | str,
        configuration: str,
        fold: int | str,
        dataset_json: dict,
        config: TrainerConfig = TrainerConfig(),
        output_folder: Optional[str] = None,
        preprocessed_dataset_folder_base: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.plans_manager = PlansManager(plans)
        self.configuration_manager = self.plans_manager.get_configuration(configuration)
        self.configuration_name = configuration
        # 2D configurations run as singleton-3D (patch (1, y, x), kernels (1, k, k))
        if len(self.configuration_manager.patch_size) == 2:
            self.configuration_manager = ConfigurationManager(
                promote_2d_configuration(self.configuration_manager.configuration))
        self.fold = fold
        self.dataset_json = dataset_json
        # smoke-test overrides of the epoch length, as the JAX trainer reads them
        if os.environ.get("ATK_ITERS_PER_EPOCH"):
            config = replace(config,
                             num_iterations_per_epoch=int(os.environ["ATK_ITERS_PER_EPOCH"]))
        if os.environ.get("ATK_VAL_ITERS"):
            config = replace(config,
                             num_val_iterations_per_epoch=int(os.environ["ATK_VAL_ITERS"]))
        self.cfg = config
        self.arch_name = config.arch_name or self.configuration_manager.UNet_class_name
        self.dtype = compute_dtype(config.compute_dtype)  # float32: TF32 off in the library ops
        self.label_manager = self.plans_manager.get_label_manager(dataset_json)
        self.preprocessed_dataset_folder_base = preprocessed_dataset_folder_base or os.path.join(
            require("preprocessed"), self.plans_manager.dataset_name)
        self.preprocessed_dataset_folder = os.path.join(
            self.preprocessed_dataset_folder_base, self.configuration_manager.data_identifier)
        self.output_folder_base = output_folder or os.path.join(
            require("results"), self.plans_manager.dataset_name,
            f"{config.name}__{self.plans_manager.plans_name}__{configuration}")
        self.output_folder = os.path.join(self.output_folder_base, f"fold_{fold}")
        os.makedirs(self.output_folder, exist_ok=True)

        self.logger = TrainingLogger()
        self.current_epoch = 0
        self.step_counter = 0
        self._best_ema: Optional[float] = None
        self.disable_checkpointing = False
        self.network = None
        self.optimizer = None
        self.inference_allowed_mirroring_axes: Optional[Tuple[int, ...]] = None
        self.epoch_timings: List[dict] = []  # seconds an epoch by part
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None
        self.device_cache_train = self.device_cache_val = None

    # --- logging --------------------------------------------------------------
    def print_to_log_file(self, *args, also_print_to_console: bool = True):
        if mesh.rank() != 0:
            return
        line = " ".join(str(a) for a in args)
        if also_print_to_console:
            print(line, flush=True)
        with open(os.path.join(self.output_folder, "training_log.txt"), "a") as f:
            f.write(line + "\n")

    def _save_debug_information(self):
        dbg = {
            "torch_version": torch.__version__,
            "device": str(self.device),
            "device_name": (torch.cuda.get_device_name(self.device)
                            if self.device.type == "cuda" else "cpu"),
            "trainer_config": {k: str(v) for k, v in self.cfg.__dict__.items()},
            "configuration_name": self.configuration_name,
            "patch_size": self.configuration_manager.patch_size,
            "batch_size": self.configuration_manager.batch_size,
        }
        with open(os.path.join(self.output_folder, "debug.json"), "w") as f:
            json.dump(dbg, f, indent=2)

    # --- splits ---------------------------------------------------------------
    def do_split(self) -> Tuple[List[str], List[str]]:
        all_keys = sorted(CaseDataset(self.preprocessed_dataset_folder).keys())
        if self.fold == "all":
            return all_keys, all_keys
        splits_file = os.path.join(self.preprocessed_dataset_folder_base, "splits_final.json")
        if not os.path.isfile(splits_file):
            splits = generate_crossval_split(all_keys, 5, seed=12345)
            if mesh.rank() == 0:
                save_json(splits, splits_file)
        else:
            splits = load_json(splits_file)
        fold = int(self.fold)
        if fold < len(splits):
            return splits[fold]["train"], splits[fold]["val"]
        # a fold beyond the splits: a random 80:20
        rng = np.random.RandomState(12345 + fold)
        idx = rng.permutation(len(all_keys))
        n_val = max(1, len(all_keys) // 5)
        return [all_keys[i] for i in idx[n_val:]], [all_keys[i] for i in idx[:n_val]]

    # --- deep supervision topology --------------------------------------------
    def _ds_factors(self) -> List[Tuple[int, ...]]:
        pools = [list(p) for p in self.configuration_manager.pool_op_kernel_sizes]
        if pools and all(p == 1 for p in pools[0]):
            pools = pools[1:]
        if self.cfg.arch_name and self.cfg.arch_name.lower().startswith("stunet"):
            while len(pools) < 5:
                pools.append([1] * len(pools[0]))
            pools = pools[:5]
        factors = [tuple([1] * len(pools[0]))]
        cur = np.ones(len(pools[0]), dtype=int)
        for p in pools[:-1]:
            cur = cur * np.asarray(p)
            factors.append(tuple(int(i) for i in cur))
        return factors[:len(pools)]

    # --- initialization -------------------------------------------------------
    def _build_network(self, deep_supervision: bool):
        cm = self.configuration_manager
        num_in = determine_num_input_channels(self.plans_manager, cm, self.dataset_json)
        return build_network_from_plans(
            self.plans_manager, cm, num_in, self.label_manager.num_segmentation_heads,
            arch_name=self.cfg.arch_name, deep_supervision=deep_supervision, dtype=self.dtype,
            device=self.device, generator=torch.Generator().manual_seed(self.cfg.seed),
            norm=self.cfg.network_norm, remat=self.cfg.remat)

    def _make_optimizer(self) -> torch.optim.Optimizer:
        """The optimizer of optax's chain after the clip: SGD's decay is added
        to the clipped gradient (add_decayed_weights), AdamW and Adan decay
        every parameter, biases and norm scales included (no mask)."""
        cfg, params = self.cfg, list(self.network.parameters())
        if cfg.optimizer == "sgd":
            return torch.optim.SGD(params, lr=cfg.initial_lr, momentum=0.99, nesterov=True,
                                   weight_decay=cfg.weight_decay)
        if cfg.optimizer == "adamw":
            return torch.optim.AdamW(params, lr=cfg.initial_lr, betas=(0.9, 0.999),
                                     eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
        if cfg.optimizer == "adam":
            return torch.optim.Adam(params, lr=cfg.initial_lr, betas=(0.9, 0.999),
                                    eps=cfg.adam_eps)
        if cfg.optimizer == "adan":
            return Adan(params, lr=cfg.initial_lr, weight_decay=cfg.weight_decay)
        raise RuntimeError(f"unknown optimizer {cfg.optimizer}")

    def initialize(self):
        cfg, cm = self.cfg, self.configuration_manager
        self.network = self._build_network(cfg.enable_deep_supervision)
        per_epoch = cfg.num_iterations_per_epoch
        base = (poly_lr_schedule(cfg.initial_lr, cfg.num_epochs) if cfg.lr_scheduler == "poly"
                else cosine_annealing_schedule(cfg.initial_lr, cfg.num_epochs))
        self._lr_schedule = lambda step: base(step // per_epoch)  # stepped per epoch
        self.optimizer = self._make_optimizer()
        self.step_counter = 0

        patch = tuple(cm.patch_size)
        rot, dummy_2d, initial_patch, mirror_axes = rotation_ranges_and_initial_patch_size(patch)
        self.inference_allowed_mirroring_axes = mirror_axes if cfg.do_mirroring_aug else None
        self.initial_patch_size = tuple(int(i) for i in initial_patch)
        ds_factors = (tuple(self._ds_factors()) if cfg.enable_deep_supervision
                      else ((1,) * len(patch),))
        mask_channels = tuple(i for i, m in enumerate(cm.use_mask_for_norm or []) if m)
        lm = self.label_manager
        # nnU-Net's order-1 seg warp: every label, the ignore label and -1
        # (the crop pad)
        seg_warp_labels = tuple(sorted({-1, *map(int, lm.all_labels)}
                                       | ({int(lm.ignore_label)} if lm.has_ignore_label
                                          else set())))
        off = IntensityAugmentConfig(p_noise=0, p_blur=0, p_brightness=0, p_contrast=0,
                                     p_lowres=0, p_gamma=0, p_gamma_invert=0)
        da5 = None
        if cfg.do_data_augmentation:
            spatial = SpatialAugmentConfig(
                patch_size=patch, rotation_x=tuple(rot["x"]), rotation_y=tuple(rot["y"]),
                rotation_z=tuple(rot["z"]), dummy_2d=dummy_2d,
                p_rotation=0.4 if cfg.aggressive_da else 0.2, p_scaling=0.2,
                data_interpolation_order0=cfg.order0_data_interp,
                data_interpolation_order=cfg.data_interpolation_order,
                seg_labels=None if cfg.order0_data_interp else seg_warp_labels)
            intensity = IntensityAugmentConfig(lowres_ignore_axis0=dummy_2d)
            if cfg.aggressive_da:  # nnU-Net's nnUNetTrainerDA5
                da5 = DA5Config()
                intensity = IntensityAugmentConfig(
                    lowres_ignore_axis0=dummy_2d, p_noise=0.1, p_lowres=0.15,
                    lowres_zoom=(0.25, 1.0), p_gamma=0.1, p_gamma_invert=0.1)
        else:
            spatial = SpatialAugmentConfig(patch_size=patch, p_rotation=0.0, p_scaling=0.0)
            intensity = off
        # a cascade stage: seg channel 1 (the previous stage) one-hot into the input
        cascade_labels = (tuple(lm.foreground_labels) if cm.previous_stage_name is not None
                          else ())
        self.aug_config = AugmentConfig(
            spatial=spatial, intensity=intensity, da5=da5,
            mirror_axes=mirror_axes if (cfg.do_mirroring_aug and cfg.do_data_augmentation)
            else (),
            mask_channels_for_norm=mask_channels, ds_scales=tuple(ds_factors),
            cascade_foreground_labels=cascade_labels)
        self.val_config = AugmentConfig(
            spatial=SpatialAugmentConfig(patch_size=patch, p_rotation=0.0, p_scaling=0.0),
            intensity=off, mirror_axes=(), mask_channels_for_norm=mask_channels,
            ds_scales=tuple(ds_factors), cascade_foreground_labels=cascade_labels)
        self.train_augment = make_train_augment_fn(self.aug_config)
        self.val_transform = make_val_transform_fn(self.val_config)
        # augmentation draws on the host (the noise field on the device, seeded from it),
        # the global batch's on every rank
        self.aug_generator = torch.Generator().manual_seed(cfg.seed + 777)
        self.global_batch = mesh.global_batch_size(cm.batch_size, mesh.world(),
                                                   self.print_to_log_file)
        self.batch_spec = mesh.shard_batch_spec(self.global_batch,
                                                cfg.oversample_foreground_percent)
        self._rows = mesh.local_rows(self.global_batch)

        if mesh.rank() == 0:
            self._save_debug_information()
            save_json(self.plans_manager.plans,
                      os.path.join(self.output_folder_base, "plans.json"), sort_keys=False)
            save_json(self.dataset_json, os.path.join(self.output_folder_base, "dataset.json"),
                      sort_keys=False)

    # --- loss -----------------------------------------------------------------
    def _single_scale_loss(self, logits: torch.Tensor, seg_target: torch.Tensor) -> torch.Tensor:
        """logits (B, *spatial, K); seg_target (B, *spatial, 1) int."""
        lm = self.label_manager
        batch_dice = bool(self.configuration_manager.batch_dice)
        t = seg_target[..., 0]
        if lm.has_regions:
            target = region_targets(t, lm.foreground_regions,
                                    lm.ignore_label if lm.has_ignore_label else None)
            return dc_and_bce_loss(logits, target, batch_dice=batch_dice,
                                   has_ignore_channel=lm.has_ignore_label)
        t = t.long()
        ignore = lm.ignore_label
        mask = None if ignore is None else (t != ignore)[..., None]
        tt = t if ignore is None else torch.where(t == ignore, torch.zeros_like(t), t)
        if self.cfg.loss == "dc_ce":
            return dc_and_ce_loss(logits, t, batch_dice=batch_dice, ignore_label=ignore)
        if self.cfg.loss == "dice":
            return memory_efficient_soft_dice_loss(logits, tt, batch_dice=batch_dice,
                                                   loss_mask=mask)
        if self.cfg.loss == "ce":
            return cross_entropy_loss(logits, tt, mask)
        if self.cfg.loss == "dc_topk":
            return dc_and_topk_loss(logits, t, batch_dice=batch_dice, ignore_label=ignore)
        raise RuntimeError(f"unknown loss {self.cfg.loss}")

    def _full_loss(self, outputs: List[torch.Tensor], targets: List[torch.Tensor]):
        n = min(len(outputs), len(targets))
        if n == 1:
            return self._single_scale_loss(outputs[0], targets[0])
        return deep_supervision_loss(outputs[:n], targets[:n], self._single_scale_loss,
                                     deep_supervision_weights(n))

    # --- steps ----------------------------------------------------------------
    def _forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, *patch, C) fp32 -> the heads' logits (B, *spatial, K) in the
        compute dtype, highest resolution first. The batch carries no
        gradient, so the stem computes no dx."""
        x = x.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)
        out = self.network(x)
        out = out if isinstance(out, (tuple, list)) else (out,)
        return [o.permute(0, 2, 3, 4, 1) for o in out]

    def train_step(self, data: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        """One step on a batch on the device (data (B, *sample patch, C), seg
        (B, *sample patch, 1) int): augmentation, forward, loss, backward,
        optax's clip, the optimizer at the step's LR. Returns the loss (no
        host sync). Under a process group the batch is this rank's rows of
        the global batch, the draws the global batch's, and the gradients and
        the loss returned the ranks' mean (JAX's step over the global batch)."""
        x, targets = self.train_augment(self.aug_generator, data, seg, rows=self._rows,
                                        global_batch=self.global_batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._full_loss(self._forward(x), targets)
        loss.backward()
        params = list(self.network.parameters())
        for p in params:  # unread heads get zero gradients, as in JAX
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = mesh.all_reduce_mean_([p.grad for p in params], loss.detach())
        clip_by_global_norm_([p.grad for p in params], self.cfg.grad_clip)
        lr = self._lr_schedule(self.step_counter)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step_counter += 1
        return loss

    @torch.no_grad()
    def val_step(self, data: torch.Tensor, seg: torch.Tensor):
        """(loss, tp, fp, fn) of a validation batch: the loss over the heads
        and the hard Dice counts of the highest-resolution head; under a
        process group the global batch's (the loss the ranks' mean, the
        counts their sum), in one all-reduce."""
        x, targets = self.val_transform(None, data, seg)
        outputs = self._forward(x)
        loss = self._full_loss(outputs, targets)
        lm = self.label_manager
        t = targets[0][..., 0]
        if lm.has_regions:
            tgt = region_targets(t, lm.foreground_regions,
                                 lm.ignore_label if lm.has_ignore_label else None)
            tp, fp, fn = hard_dice_parts(outputs[0], tgt, has_regions=True,
                                         ignore_label=lm.ignore_label)
        else:
            tp, fp, fn = hard_dice_parts(outputs[0], t, ignore_label=lm.ignore_label)
        if mesh.distributed():
            w = mesh.world()
            summed = mesh.all_reduce_sum(torch.cat([loss.reshape(1).float() / w, tp, fp, fn]))
            loss, (tp, fp, fn) = summed[0], summed[1:].chunk(3)
        return loss, tp, fp, fn

    # --- dataloaders ----------------------------------------------------------
    def previous_stage_folder(self) -> Optional[str]:
        """A cascade stage's previous-stage predictions:
        <results>/<dataset>/<trainer>__<plans>__<previous stage>/predicted_next_stage/
        <this configuration>, which the previous stage's final validation
        writes; None for any other configuration. Raises where it is missing."""
        prev = self.configuration_manager.previous_stage_name
        if prev is None:
            return None
        parent, model_dir = os.path.split(self.output_folder_base.rstrip(os.sep))
        folder = os.path.join(parent, model_dir.rsplit("__", 1)[0] + f"__{prev}",
                              "predicted_next_stage", self.configuration_name)
        if not os.path.isdir(folder):
            raise RuntimeError(
                f"Cascade stage requires previous-stage predictions at {folder}. Train {prev} "
                f"(incl. final validation) first.")
        return folder

    def get_dataloaders(self):
        tr_keys, val_keys = self.do_split()
        cfg, cm = self.cfg, self.configuration_manager
        prev_folder = self.previous_stage_folder()
        ds_tr = CaseDataset(self.preprocessed_dataset_folder, tr_keys, prev_folder)
        ds_val = CaseDataset(self.preprocessed_dataset_folder, val_keys, prev_folder)
        annotated_key = tuple(self.label_manager.all_labels)
        patch = tuple(cm.patch_size)
        sample_patch = self.initial_patch_size if cfg.do_data_augmentation else patch
        bs, os_pct = self.batch_spec
        has_ignore = self.label_manager.has_ignore_label
        seed = cfg.seed + 131071 * mesh.rank()
        self.sampler_train = PatchSampler(
            ds_tr, bs, sample_patch, final_patch_size=patch,
            oversample_foreground_percent=os_pct, annotated_classes_key=annotated_key,
            has_ignore=has_ignore, probabilistic_oversampling=cfg.probabilistic_oversampling,
            seed=seed, cascade_corruption=prev_folder is not None)
        self.sampler_val = PatchSampler(
            ds_val, bs, patch, final_patch_size=patch, oversample_foreground_percent=os_pct,
            annotated_classes_key=annotated_key, has_ignore=has_ignore, seed=seed + 1)
        n_workers = (cfg.num_workers if cfg.num_workers is not None
                     else min(4, get_allowed_n_proc_DA()))
        self.loader_train = PrefetchPipeline(
            self.sampler_train, num_workers=n_workers, device=self.device,
            transfer_dtype=torch.bfloat16 if self.dtype == torch.bfloat16 else None)
        self.loader_val = PrefetchPipeline(self.sampler_val, num_workers=max(1, n_workers // 2),
                                           device=self.device)
        self._setup_device_cache(ds_tr, ds_val, sample_patch, patch, annotated_key)
        return self.loader_train, self.loader_val

    def _setup_device_cache(self, ds_tr, ds_val, sample_patch, patch, annotated_key):
        """The GPU case cache, where it holds the labels exactly, the stage
        reads no previous stage and one process runs; else the host
        pipeline."""
        from anatomask_torch.data.device_cache import DeviceCaseCache
        self.device_cache_train = self.device_cache_val = None
        cfg, lm = self.cfg, self.label_manager
        enabled = cfg.device_cache
        if enabled is None:
            enabled = os.environ.get("ATK_SUP_DEVICE_CACHE", "1") == "1"
        if not enabled or cfg.benchmark_no_dataloading:
            return
        labels = list(lm.all_labels) + ([lm.ignore_label] if lm.has_ignore_label else [])
        reasons = []
        if mesh.world() > 1:
            reasons.append("multi-process run")
        if self.configuration_manager.previous_stage_name is not None:
            reasons.append("cascade stage (prev-stage seg channels)")
        if self.dtype == torch.bfloat16 and max(abs(int(v)) for v in labels) > 256:
            reasons.append("labels exceed bf16 exact-integer range")
        if reasons:
            self.print_to_log_file(f"[device-cache] falling back to the host pipeline: "
                                   f"{'; '.join(reasons)}")
            return
        common = dict(oversample_foreground_percent=cfg.oversample_foreground_percent,
                      probabilistic_oversampling=cfg.probabilistic_oversampling,
                      annotated_classes_key=annotated_key, has_ignore=lm.has_ignore_label,
                      batch_size=self.global_batch, dtype=self.dtype,
                      include_seg=True, whole_dataset_mode=True, device=self.device)
        cache = DeviceCaseCache(ds_tr, initial_patch=sample_patch, final_patch=patch,
                                capacity_mb=cfg.device_cache_mb, seed=cfg.seed + 555, **common)
        steps_per_slot = int(os.environ.get(
            "ATK_SUP_CACHE_STEPS_PER_SLOT",
            max(1, max(1, cfg.num_iterations_per_epoch) // cache.num_slots)))
        if cache.whole_dataset_resident:
            self.print_to_log_file("[device-cache] whole training set resident; refills off")
        else:
            cache.start_refill(steps_per_slot=steps_per_slot)
        self.device_cache_train = cache
        if cfg.num_val_iterations_per_epoch > 0:
            val = DeviceCaseCache(ds_val, initial_patch=patch, final_patch=patch,
                                  capacity_mb=max(256, cfg.device_cache_mb // 4),
                                  seed=cfg.seed + 556, **common)
            if not val.whole_dataset_resident:
                val.start_refill(steps_per_slot=max(
                    1, cfg.num_val_iterations_per_epoch // val.num_slots))
            self.device_cache_val = val
        self.print_to_log_file(
            f"[device-cache] supervised: {cache.num_slots} train + "
            f"{getattr(self.device_cache_val, 'num_slots', 0)} val slots of "
            f"{cache.slot_shape} on {self.device} (~{cfg.device_cache_mb} MB budget), refill "
            f"every {steps_per_slot} steps; host sends only (slot, origin) pairs")

    @staticmethod
    def _cache_batch(cache) -> Dict[str, torch.Tensor]:
        data, seg = cache.extract_split(*cache.sample_batch())
        return {"data": data, "seg": seg}

    # --- checkpointing --------------------------------------------------------
    def _checkpoint_meta(self) -> dict:
        return {
            "trainer_name": self.cfg.name,
            "configuration_name": self.configuration_name,
            "current_epoch": self.current_epoch + 1,
            "_best_ema": self._best_ema,
            "logging": self.logger.get_checkpoint(),
            "inference_allowed_mirroring_axes": (
                list(self.inference_allowed_mirroring_axes)
                if self.inference_allowed_mirroring_axes is not None else None),
            "network_arch_name": self.cfg.arch_name,
            "step_counter": self.step_counter,
            "torch_optimizer_param_groups": self.optimizer.state_dict()["param_groups"],
        }

    def _snapshot_state(self) -> dict:
        """One host copy of the weights and the optimizer state, taken on the
        main thread before a writer thread gets it (the optimizer writes the
        device tensors in place)."""
        return {
            "network_weights": {k: v.detach().to("cpu", copy=True)
                                for k, v in self.network.state_dict().items()},
            "torch_optimizer_state": {
                str(i): {k: v.detach().to("cpu", copy=True) for k, v in st.items()}
                for i, st in self.optimizer.state_dict()["state"].items()},
        }

    def _checkpoint_arrays(self, snapshot: dict) -> dict:
        """A snapshot as the checkpoint's arrays: the weights in the JAX
        package's layout, the optimizer state as numpy."""
        return {
            "network_weights": state_dict_to_jax(self.arch_name, snapshot["network_weights"]),
            "torch_optimizer_state": {i: {k: v.numpy() for k, v in st.items()}
                                      for i, st in snapshot["torch_optimizer_state"].items()},
        }

    def _join_ckpt_writer(self):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
            err, self._ckpt_error = self._ckpt_error, None
            if err is not None:
                raise RuntimeError("background checkpoint write failed") from err

    def _write_checkpoints_async(self, filenames, snapshot: dict, meta: dict):
        """The snapshot into each of `filenames`, converted and written on a
        background thread that overlaps the next epoch; at most one writer
        outstanding; a failed write is re-raised at the next join."""
        self._join_ckpt_writer()

        def write():
            try:
                first, *rest = (os.path.join(self.output_folder, f) for f in filenames)
                ckpt_lib.save_checkpoint(first, self._checkpoint_arrays(snapshot), meta)
                for path in rest:  # the same bytes: a file copy, no second serialisation
                    shutil.copyfile(first, path + ".tmp")
                    os.replace(path + ".tmp", path)
            except BaseException as e:  # re-raised in _join_ckpt_writer
                self._ckpt_error = e
                self.print_to_log_file(f"CHECKPOINT WRITE FAILED: {e!r}")

        self._ckpt_thread = threading.Thread(target=write, daemon=True)
        self._ckpt_thread.start()

    def save_checkpoint(self, filename: str):
        if self.disable_checkpointing or mesh.rank() != 0:
            return  # the ranks' weights are identical: rank 0 writes for all
        self._join_ckpt_writer()
        ckpt_lib.save_checkpoint(os.path.join(self.output_folder, filename),
                                 self._checkpoint_arrays(self._snapshot_state()),
                                 self._checkpoint_meta())

    def load_checkpoint(self, filename_or_path: str):
        """A checkpoint of this trainer or of the JAX one: the weights, the
        epoch, the step counter, the logs; the optimizer state where the
        file holds the port's."""
        self._join_ckpt_writer()
        path = (filename_or_path if os.path.isabs(filename_or_path)
                else os.path.join(self.output_folder, filename_or_path))
        arrays, meta = ckpt_lib.load_checkpoint(path)
        if self.network is None:
            self.initialize()
        self.network.load_state_dict(state_dict_from_jax(self.arch_name,
                                                         arrays["network_weights"]))
        groups = meta.get("torch_optimizer_param_groups")
        if groups is not None:
            state = {int(i): {k: torch.from_numpy(np.asarray(v)) for k, v in st.items()}
                     for i, st in arrays.get("torch_optimizer_state", {}).items()}
            self.optimizer.load_state_dict({"state": state, "param_groups": groups})
        self.current_epoch = meta.get("current_epoch", 0)
        self._best_ema = meta.get("_best_ema")
        self.step_counter = meta.get("step_counter",
                                     self.current_epoch * self.cfg.num_iterations_per_epoch)
        if meta.get("logging"):
            self.logger.load_checkpoint(meta["logging"])
        mirroring = meta.get("inference_allowed_mirroring_axes")
        if mirroring is not None:
            self.inference_allowed_mirroring_axes = tuple(mirroring)

    # --- training loop --------------------------------------------------------
    def _dummy_batches(self):
        """benchmark_no_dataloading: one random training and one validation
        batch, put on the device once."""
        cm = self.configuration_manager
        num_in = determine_num_input_channels(self.plans_manager, cm, self.dataset_json)
        bs = self.batch_spec[0]
        rs = np.random.RandomState(self.cfg.seed + 131071 * mesh.rank())

        def dummy(spatial):
            data = rs.rand(bs, *spatial, num_in).astype(np.float32)
            seg = rs.randint(0, max(2, len(self.label_manager.all_labels)),
                             (bs, *spatial, 1)).astype(np.int16)
            return {"data": torch.from_numpy(data).to(self.device),
                    "seg": torch.from_numpy(seg).to(self.device)}

        sample_patch = (self.initial_patch_size if self.cfg.do_data_augmentation
                        else tuple(cm.patch_size))
        val = dummy(tuple(cm.patch_size)) if self.cfg.num_val_iterations_per_epoch > 0 else None
        return dummy(sample_patch), val

    def run_training(self, continue_training: bool = False):
        if self.network is None:
            self.initialize()
        if continue_training:
            for candidate in ("checkpoint_latest.npz", "checkpoint_best.npz"):
                p = os.path.join(self.output_folder, candidate)
                if os.path.isfile(p):
                    self.print_to_log_file(f"resuming from {candidate}")
                    self.load_checkpoint(p)
                    break
        if mesh.rank() == 0:
            unpack_dataset(self.preprocessed_dataset_folder,
                           num_processes=min(4, get_allowed_n_proc_DA()))
            self.do_split()  # writes splits_final.json where it is missing
        mesh.barrier()
        self.get_dataloaders()
        cfg = self.cfg
        dummy_batch = dummy_val_batch = None
        if cfg.benchmark_no_dataloading:
            dummy_batch, dummy_val_batch = self._dummy_batches()
        # with the case cache the host prefetch threads never start
        cache_tr, cache_val = self.device_cache_train, self.device_cache_val
        train_iter = (iter(self.loader_train) if cache_tr is None and dummy_batch is None
                      else None)
        val_iter = (iter(self.loader_val) if cache_val is None and dummy_val_batch is None
                    else None)
        try:
            for epoch in range(self.current_epoch, cfg.num_epochs):
                self.current_epoch = epoch
                t0 = time.time()
                self.logger.log("epoch_start_timestamps", t0, epoch)
                self.logger.log("lrs", float(self._lr_schedule(self.step_counter)), epoch)
                losses, t_fetch = [], 0.0
                for _ in range(cfg.num_iterations_per_epoch):
                    f0 = time.time()
                    if dummy_batch is not None:
                        batch = dummy_batch
                    elif cache_tr is not None:
                        batch = self._cache_batch(cache_tr)
                    else:
                        batch = next(train_iter)
                    t_fetch += time.time() - f0
                    losses.append(self.train_step(batch["data"], batch["seg"]))
                    if cache_tr is not None:
                        cache_tr.maybe_refill()
                train_loss = (torch.stack(losses).float().mean().item() if losses
                              else float("nan"))
                t_train = time.time() - t0
                if not np.isfinite(train_loss):
                    self.print_to_log_file(
                        f"WARNING: non-finite train loss at epoch {epoch}: {train_loss}")
                self.logger.log("train_losses", train_loss, epoch)

                tv0 = time.time()
                if cfg.num_val_iterations_per_epoch > 0:
                    outs = []
                    for _ in range(cfg.num_val_iterations_per_epoch):
                        if dummy_val_batch is not None:
                            batch = dummy_val_batch
                        elif cache_val is not None:
                            batch = self._cache_batch(cache_val)
                            cache_val.maybe_refill()
                        else:
                            batch = next(val_iter)
                        outs.append(self.val_step(batch["data"], batch["seg"]))
                    val_loss = torch.stack([o[0] for o in outs]).float().mean().item()
                    tp, fp, fn = (torch.stack([o[i] for o in outs]).sum(0).cpu().numpy()
                                  for i in (1, 2, 3))
                    dice_per_class = [float(2 * i / (2 * i + j + k)) if (2 * i + j + k) > 0
                                      else 0.0 for i, j, k in zip(tp, fp, fn)]
                    self.logger.log("val_losses", val_loss, epoch)
                    self.logger.log("dice_per_class_or_region", dice_per_class, epoch)
                    self.logger.log("mean_fg_dice", float(np.nanmean(dice_per_class)), epoch)
                t_val = time.time() - tv0
                t_ckpt = self.on_epoch_end(epoch)
                self.epoch_timings.append(dict(epoch=epoch, total=time.time() - t0,
                                               train=t_train, fetch_wait=t_fetch, val=t_val,
                                               ckpt=t_ckpt))
        finally:
            self._join_ckpt_writer()
            self.loader_train.stop()
            self.loader_val.stop()
            for cache in (cache_tr, cache_val):
                if cache is not None:
                    cache.stop()
        self.save_checkpoint("checkpoint_final.npz")
        latest = os.path.join(self.output_folder, "checkpoint_latest.npz")
        if mesh.rank() == 0 and os.path.isfile(latest):
            os.remove(latest)
        if cfg.benchmark and mesh.rank() == 0:
            self._write_benchmark_result()

    def on_epoch_end(self, epoch: int) -> float:
        """Logs the epoch, tracks the best EMA pseudo-Dice and starts the
        checkpoint writes; returns the seconds the main thread spent on
        them."""
        t1 = time.time()
        self.logger.log("epoch_end_timestamps", t1, epoch)
        lg = self.logger.logging

        def get(key):
            lst = lg[key]
            return lst[epoch] if len(lst) > epoch else None

        dur = t1 - lg["epoch_start_timestamps"][epoch]
        msg = f"epoch {epoch}: train_loss {lg['train_losses'][epoch]:.4f}"
        if get("val_losses") is not None:
            msg += f" val_loss {get('val_losses'):.4f}"
        ema = get("ema_fg_dice")
        if ema is not None:
            msg += f" ema_fg_dice {ema:.4f}"
        self.print_to_log_file(msg + f" time {dur:.2f}s")

        need_latest = (epoch + 1) % self.cfg.save_every == 0 and epoch != self.cfg.num_epochs - 1
        is_best = ema is not None and (self._best_ema is None or ema > self._best_ema)
        if is_best:
            self._best_ema = ema
            self.print_to_log_file(f"new best EMA pseudo Dice: {ema:.4f}")
        if (need_latest or is_best) and not self.disable_checkpointing and mesh.rank() == 0:
            files = [f for f, on in (("checkpoint_latest.npz", need_latest),
                                     ("checkpoint_best.npz", is_best)) if on]
            self._write_checkpoints_async(files, self._snapshot_state(), self._checkpoint_meta())
        t_ckpt = time.time() - t1
        if mesh.rank() == 0:
            self.logger.plot_progress_png(self.output_folder)
        return t_ckpt

    def _write_benchmark_result(self):
        """The fastest epoch into benchmark_result.json, keyed by the torch
        version and the device's name."""
        fastest = min((e["total"] for e in self.epoch_timings), default=None)
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                else "cpu")
        out_file = os.path.join(self.output_folder, "benchmark_result.json")
        existing = load_json(out_file) if os.path.isfile(out_file) else {}
        existing[f"{torch.__version__}__{name.replace(' ', '_')}"] = {
            "torch_version": torch.__version__, "device": name, "num_devices": mesh.world(),
            "fastest_epoch": fastest, "trainer": self.cfg.name}
        save_json(existing, out_file)

    # --- final validation -----------------------------------------------------
    def perform_actual_validation(self, save_probabilities: bool = False):
        """Every validation case of the fold through the sliding-window
        Predictor (the network without deep supervision, this trainer's
        weights and mirroring), exported; the next stages' resampled
        predictions; then the metrics against the ground truth into
        validation/summary.json. A cascade stage predicts each case with the
        previous stage's one-hot stacked under the data, as nnU-Net does (the
        JAX trainer leaves it out: ROADMAP.md §3 item 7). Under a process
        group each rank predicts `val_keys[rank::world]` with its batch's own
        BatchNorm statistics, and rank 0 computes the metrics once every rank
        has written (a barrier the JAX trainer lacks: ROADMAP.md §3 item 8);
        the other ranks return None."""
        from anatomask_torch.evaluation.metrics import compute_metrics_on_folder
        from anatomask_torch.inference.export import (export_prediction_from_logits,
                                                      resample_and_save)
        from anatomask_torch.inference.predictor import Predictor

        predictor = Predictor(tile_step_size=0.5, use_gaussian=True,
                              use_mirroring=self.inference_allowed_mirroring_axes is not None,
                              verbose=False, dtype=self.dtype, device=self.device)
        cm, pm = self.configuration_manager, self.plans_manager
        net = self._build_network(deep_supervision=False)
        for m in net.modules():  # the ranks predict different cases
            if isinstance(m, BatchNorm):
                m.cross_rank = False
        predictor.manual_initialization(net, pm, cm, [self.network.state_dict()],
                                        self.dataset_json, self.inference_allowed_mirroring_axes)
        validation_folder = os.path.join(self.output_folder, "validation")
        os.makedirs(validation_folder, exist_ok=True)
        _, val_keys = self.do_split()
        val_keys = val_keys[mesh.rank()::mesh.world()]
        dataset_val = CaseDataset(self.preprocessed_dataset_folder, val_keys,
                                  self.previous_stage_folder())
        cascade = cm.previous_stage_name is not None
        for k in val_keys:
            print(f"[validation] rank {mesh.rank()}: predicting {k}", flush=True)
            data, seg, properties = dataset_val.load_case(k)
            data = np.asarray(data)
            if cascade:
                data = np.vstack([data, convert_labelmap_to_one_hot(
                    np.asarray(seg[-1]), self.label_manager.foreground_labels,
                    output_dtype=data.dtype)])
            logits = predictor.predict_sliding_window_return_logits(data)
            export_prediction_from_logits(logits, properties, cm, pm, self.dataset_json,
                                          os.path.join(validation_folder, k),
                                          save_probabilities)
            for ns in cm.next_stage_names or ():
                next_cm = pm.get_configuration(ns)
                pp_next = os.path.join(self.preprocessed_dataset_folder_base,
                                       next_cm.data_identifier)
                try:
                    tgt_shape = np.load(os.path.join(pp_next, k + ".npz"))["data"].shape[1:]
                except FileNotFoundError:
                    continue
                out_dir = os.path.join(self.output_folder_base, "predicted_next_stage", ns)
                os.makedirs(out_dir, exist_ok=True)
                resample_and_save(logits, tgt_shape, os.path.join(out_dir, k + ".npz"), pm, cm,
                                  properties, self.dataset_json)
        mesh.barrier()
        if mesh.rank() != 0:
            return None
        gt_folder = os.path.join(self.preprocessed_dataset_folder_base, "gt_segmentations")
        if not os.path.isdir(gt_folder):
            gt_folder = os.path.join(require("raw"), pm.dataset_name, "labelsTr")
        lm = self.label_manager
        metrics = compute_metrics_on_folder(
            gt_folder, validation_folder, os.path.join(validation_folder, "summary.json"),
            pm.image_reader_writer_class(), self.dataset_json["file_ending"],
            lm.foreground_regions if lm.has_regions else lm.foreground_labels,
            lm.ignore_label)
        self.print_to_log_file("Validation complete. Mean Dice:",
                               metrics["foreground_mean"]["Dice"])
        return metrics

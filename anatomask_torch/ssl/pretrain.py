"""MIM pretraining: the AnatoMask teacher-student step, the SparK random-mask
step, and the trainer that runs them the way users run pretraining.
Counterpart of anatomask_tpu/ssl/pretrain.py.

`anatomask_train_step` is the step that the JAX package builds and bench.py
times, in `grad_accum_steps` microbatches (JAX's `_accumulate`):

1. per microbatch, in turn: the EMA teacher reconstructs under a random mask
   (no_grad), its per-patch loss picks the hard mask
   (`generate_guided_mask`), the student runs forward and backward under it;
2. the summed gradients divided by the microbatch count, global-norm clip,
   then AdamW or LAMB on the student at the step's LR;
3. EMA update of the teacher at the epoch's decay.

`build_spark_model` builds every configuration of the JAX PretrainConfig:
STUNet-S/B/L/H or MedNeXt encoders, densify norms "in"/"bn"/"ln", decoder
norms "in"/"bn", the batch-pooled norms of the reference-fidelity mode, and
activation checkpointing (`remat`, always on for STUNet-H).

`PretrainTrainer.run_pretraining` wraps it as `atk_pretrain` does: the case
split, the foreground-oversampling patch sampler, the GPU-resident case cache
(or the host pipeline), on-device spatial augmentation from an enlarged
initial patch, the warmup-cosine LR, the per-epoch EMA decay and easy-to-hard
keep ratio, validation, the non-finite-loss abort, and checkpoints with
resume. JAX's chunked `lax.scan` over steps is a plain Python loop here.

`load_ssl_encoder_into_trainer` starts AnatoMask's finetuning: the pretrained
encoder goes into a supervised Trainer's STUNet.
"""
from __future__ import annotations

import copy
import json
import math
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from anatomask_torch.configuration import get_allowed_n_proc_DA
from anatomask_torch.convert import stunet_state_dict_from_jax
from anatomask_torch.data.augment import (AugmentConfig, IntensityAugmentConfig,
                                          SpatialAugmentConfig, make_train_augment_fn,
                                          rotation_ranges_and_initial_patch_size)
from anatomask_torch.data.dataset import CaseDataset, unpack_dataset
from anatomask_torch.data.device_cache import DeviceCaseCache
from anatomask_torch.data.pipeline import PrefetchPipeline
from anatomask_torch.data.sampler import PatchSampler
from anatomask_torch.device import compute_dtype, resolve_device
from anatomask_torch.parallel import mesh
from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import PlansManager, load_json, save_json
from anatomask_torch.ssl.anatomask import generate_guided_mask, guided_keep_ratio
from anatomask_torch.ssl.decoder import LightDecoder
from anatomask_torch.ssl.ema import ema_decay_schedule, ema_update
from anatomask_torch.ssl.mednext import SparseMedNeXtEncoder
from anatomask_torch.ssl.spark import SparK, random_keep_mask, spark_loss
from anatomask_torch.ssl.sparse import SparseSTUNetEncoder
from anatomask_torch.training import checkpoint as ckpt_lib
from anatomask_torch.training.schedules import linear_warmup_cosine_schedule
from anatomask_torch.training.trainer import clip_by_global_norm_, generate_crossval_split
from anatomask_torch.utils.tracing import span

_STUNET_WIDTHS = {"S": 16, "B": 32, "L": 64, "H": 96}  # the encoder's width multiplier
_STUNET_DEPTHS = {"S": 1, "B": 1, "L": 2, "H": 3}      # its blocks a stage


@dataclass(frozen=True)
class PretrainConfig:
    """anatomask_tpu's PretrainConfig, every field with its default. The
    encoder is STUNet-`model_size` (dims 16/32/64/96 x (1, 2, 4, 8, 16), depth
    1/1/2/3 a stage; `encoder_dims` and `encoder_depth` override them) or,
    with encoder_type "mednext", MedNeXt of width encoder_dims[0] (default
    32). The LightDecoder is `decoder_width` wide (default the encoder's top
    width). remat (activation checkpointing a stage and a decoder block) is
    on for STUNet-H whatever the field says. batch_size is the global batch,
    scaled up to a multiple of the rank count (JAX's default
    scale_batch_to_devices), and grad_accum_steps is lowered until it
    divides it into microbatches that divide among the ranks."""
    method: str = "anatomask"            # "spark" (random mask) | "anatomask"
    model_size: str = "B"                # STUNet S/B/L/H encoder head
    patch_size: Tuple[int, int, int] = (112, 112, 128)
    batch_size: int = 4
    mask_ratio: float = 0.6
    densify_norm: str = "in"             # "in" | "bn" | "ln" | anything else: none
    decoder_norm: str = "in"             # "in" | "bn" (the reference's BatchNorm3d)
    decoder_width: Optional[int] = None
    # reference-fidelity mode: the encoder's and the "in" densify norms pool
    # their statistics over the batch's visible voxels (with decoder_norm="bn")
    norm_batch_pooled: bool = False
    num_epochs: int = 1000
    iters_per_epoch: Optional[int] = None  # default floor(n_train / batch)
    lr: float = 1e-4
    optimizer: str = "adamw"             # "adamw" | "lamb"
    weight_decay: float = 1e-5
    warmup_epochs: int = 20
    grad_clip: float = 12.0
    oversample_foreground_percent: float = 0.33
    val_fraction: float = 0.15
    ema_decay_start: float = 0.999
    ema_decay_end: float = 0.9999
    guide: bool = True                   # easy-to-hard curriculum
    compute_dtype: str = "bfloat16"
    num_workers: Optional[int] = None
    seed: int = 42
    save_every: int = 1
    remat: bool = False
    grad_accum_steps: int = 1            # microbatches a step, gradients summed
    # GPU-resident case cache; None = on unless ATK_DEVICE_CACHE=0
    device_cache: Optional[bool] = None
    device_cache_mb: int = 1024
    encoder_dims: Optional[Tuple[int, ...]] = None
    encoder_depth: Optional[Tuple[int, ...]] = None
    encoder_type: str = "stunet"         # "stunet" | "mednext"


def build_spark_model(cfg: PretrainConfig, in_channels: int = 1, device="cuda",
                      generator: Optional[torch.Generator] = None) -> SparK:
    """The SparK of `cfg` (the JAX package's build_spark_model), initialised on
    the CPU from `generator` (default: seed 0), then moved to `device`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dtype = compute_dtype(cfg.compute_dtype)  # float32: TF32 off in the library ops
    if cfg.encoder_type == "mednext":
        n = cfg.encoder_dims[0] if cfg.encoder_dims else 32
        enc = SparseMedNeXtEncoder(in_channels, n, dtype=dtype, generator=generator,
                                   remat=cfg.remat)
        remat, pooled = cfg.remat, False
    else:
        size = cfg.model_size.upper()
        if size not in _STUNET_WIDTHS:
            raise ValueError(f"model_size must be one of {sorted(_STUNET_WIDTHS)}, "
                             f"got {cfg.model_size!r}")
        dims = (tuple(cfg.encoder_dims) if cfg.encoder_dims
                else tuple(_STUNET_WIDTHS[size] * m for m in (1, 2, 4, 8, 16)))
        depth = (tuple(cfg.encoder_depth) if cfg.encoder_depth
                 else (_STUNET_DEPTHS[size],) * len(dims))
        remat, pooled = cfg.remat or size == "H", cfg.norm_batch_pooled
        # the mask's visible patches a sample, as SparK computes them: the
        # block-sparse route's static block count (ATK_BLOCK_SPARSE=1)
        fmap = [int(p) // 2 ** (len(dims) - 1) for p in cfg.patch_size]
        len_keep = round(math.prod(fmap) * (1 - cfg.mask_ratio))
        enc = SparseSTUNetEncoder(in_channels, dims, dtype, generator, depth=depth, remat=remat,
                                  norm_batch_pooled=pooled, len_keep=len_keep)
    dec = LightDecoder(enc.get_downsample_ratio(), cfg.decoder_width or enc.dims[-1],
                       in_channels, dtype, generator, norm=cfg.decoder_norm, remat=remat)
    model = SparK(enc, dec, cfg.patch_size, dtype, generator, mask_ratio=cfg.mask_ratio,
                  densify_norm=cfg.densify_norm, norm_batch_pooled=pooled)
    return model.to(device)


def make_teacher(student: nn.Module) -> nn.Module:
    """A frozen copy of the student, for the EMA updates."""
    return copy.deepcopy(student).requires_grad_(False)


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """name -> True where weight decay applies: not on mask tokens (5-D here,
    so excluded by name), biases, or 1-D parameters such as norm weights."""
    return {name: "mask_token" not in name and "bias" not in name and p.ndim > 1
            for name, p in model.named_parameters()}


class Lamb(torch.optim.Optimizer):
    """optax.lamb after the clip, as the JAX trainer chains it: scale_by_adam
    (b1 0.9, b2 0.999, eps 1e-6, eps_root 0, bias-corrected moments), the
    group's weight decay added (add_decayed_weights), each parameter's update
    scaled by ||p|| / ||u|| (scale_by_trust_ratio: 1 where either norm is 0),
    then -lr. A parameter here is a leaf of the JAX tree (convert.py's
    converters map one to one), so the trust ratio is taken over the same
    elements."""

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            # optax's bias corrections 1 - decay**count, in fp32
            f1, f2 = (torch.tensor(b, dtype=torch.float32) for b in (b1, b2))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, st = p.grad, self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                mu = st["exp_avg"].copy_((1 - b1) * g + b1 * st["exp_avg"])
                nu = st["exp_avg_sq"].copy_((1 - b2) * g.square() + b2 * st["exp_avg_sq"])
                u = (mu / (1 - f1 ** t)) / ((nu / (1 - f2 ** t)).sqrt() + group["eps"])
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * p
                p_norm, u_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
                p.add_(u * ratio * -group["lr"])


def make_optimizer(model: nn.Module, cfg: PretrainConfig = PretrainConfig()
                   ) -> torch.optim.Optimizer:
    """cfg.optimizer at cfg.lr with cfg.weight_decay where no_decay_mask says:
    AdamW (betas 0.9/0.999, eps 1e-8) or Lamb."""
    decay = no_decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if decay[n]], "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in params.items() if not decay[n]], "weight_decay": 0.0},
    ]
    if cfg.optimizer == "lamb":
        return Lamb(groups, lr=cfg.lr)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    raise ValueError(f"optimizer must be 'adamw' or 'lamb', got {cfg.optimizer!r}")


def accumulation_steps(batch: int, requested: int, n_shards: int = 1) -> int:
    """The microbatches a step, JAX's rule: `requested`, lowered until it
    divides the global batch into microbatches that divide among n_shards
    ranks."""
    micro = max(1, int(requested))
    while micro > 1 and (batch % micro or (batch // micro) % n_shards):
        micro -= 1
    return micro


def _microbatches(batch: int, grad_accum_steps: int) -> List[slice]:
    if batch % grad_accum_steps:
        raise ValueError(f"grad_accum_steps {grad_accum_steps} does not divide batch {batch}")
    mb = batch // grad_accum_steps
    return [slice(j * mb, (j + 1) * mb) for j in range(grad_accum_steps)]


def _update(student: SparK, optimizer: torch.optim.Optimizer, micro: int, lr: float,
            grad_clip: float, loss: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """The gradients summed over `micro` microbatches, under a process group
    averaged over the ranks in one all-reduce (with `loss`), divided by
    `micro`; optax's clip, then the optimizer at `lr` (set on every group).
    Returns `loss`, averaged over the ranks."""
    params = list(student.parameters())
    for p in params:  # unread parameters get zero gradients, as in JAX
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    loss = mesh.all_reduce_mean_([p.grad for p in params], loss)
    if micro > 1:
        for p in params:
            p.grad.div_(micro)
    clip_by_global_norm_([p.grad for p in params], grad_clip)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.step()
    return loss


def _rank_noise(noise: Optional[torch.Tensor], shape, generator, device, micro: int
                ) -> torch.Tensor:
    """This rank's rows (`mesh.local_rows`, dim -2) of the uniforms of the
    global batch (dim -2 of `shape`, the rank's rows times the world size):
    `noise`, or drawn from `generator`, the same on every rank."""
    shape = (*shape[:-2], shape[-2] * mesh.world(), shape[-1])
    if noise is None:
        noise = torch.rand(shape, generator=generator, device=device)
    rows = mesh.local_rows(shape[-2], micro)
    return noise if rows is None else noise.index_select(-2, rows.to(noise.device))


def anatomask_train_step(student: SparK, teacher: SparK, optimizer: torch.optim.Optimizer,
                         x: torch.Tensor, len_loss: int,
                         generator: Optional[torch.Generator] = None, *,
                         noise: Optional[torch.Tensor] = None, ema_decay: float = 0.999,
                         lr: float = 1e-4, grad_clip: float = 12.0,
                         grad_accum_steps: int = 1):
    """One AnatoMask step on x (B, C, H, W, D) in grad_accum_steps
    microbatches, each in turn: the teacher's pass under a random mask
    (no_grad), the guided hard mask from its per-patch loss, the student's
    forward and backward under it. The gradients are summed, divided by the
    microbatch count, clipped and applied; then the EMA update. The two (B,
    L) uniform draws (random teacher mask, guided-mask noise) come from
    `generator`, or from `noise` (2, B, L) where a test supplies them; a
    microbatch takes its rows. Returns (the mean of the microbatches' student
    losses, hard mask, teacher per-patch loss map), the last two over the
    whole batch.

    Under a process group x is this rank's rows of the global batch
    (`mesh.local_rows`: its share of every microbatch), the uniforms are drawn
    for the global batch (or `noise` holds them, (2, global B, L)) and the
    rank takes its rows; the losses returned are the global batch's, the
    masks and maps the rank's."""
    with span("pretrain.step"):
        B = x.shape[0]
        L = math.prod(student.fmap)
        noise = _rank_noise(noise, (2, B, L), generator, x.device, grad_accum_steps)
        with span("pretrain.update"):
            optimizer.zero_grad(set_to_none=False)
        losses, hards, maps = [], [], []
        for sl in _microbatches(B, grad_accum_steps):
            xb = x[sl]
            with torch.no_grad():
                with span("pretrain.teacher"):
                    mask1 = random_keep_mask(xb.shape[0], student.fmap, student.len_keep,
                                             noise=noise[0, sl])
                    inp1, rec1 = teacher(xb, mask1)
                    _, loss_map = spark_loss(inp1, rec1, mask1)
                with span("pretrain.hard_mask"):
                    hard, _ = generate_guided_mask(loss_map, student.fmap, student.len_keep,
                                                   len_loss, noise=noise[1, sl])
            with span("pretrain.student_forward"):
                inp, rec = student(xb, hard)
                loss = spark_loss(inp, rec, hard)[0]
            with span("pretrain.backward"):
                loss.backward()
            losses.append(loss.detach())
            hards.append(hard)
            maps.append(loss_map)
        with span("pretrain.update"):
            loss = _update(student, optimizer, grad_accum_steps, lr, grad_clip,
                           torch.stack(losses).mean())
        with span("pretrain.ema"):
            ema_update(teacher, student, ema_decay)
        return loss, torch.cat(hards), torch.cat(maps)


def spark_train_step(student: SparK, optimizer: torch.optim.Optimizer, x: torch.Tensor,
                     generator: Optional[torch.Generator] = None, *,
                     noise: Optional[torch.Tensor] = None, lr: float = 1e-4,
                     grad_clip: float = 12.0, grad_accum_steps: int = 1) -> torch.Tensor:
    """One SparK step on x (B, C, H, W, D) in grad_accum_steps microbatches:
    a uniformly random mask (from `generator`, or the rows of the (B, L)
    uniforms `noise`), forward, backward; then the summed gradients divided
    by the microbatch count, clip, the optimizer. No teacher. Returns the
    mean of the microbatches' losses. Under a process group as
    anatomask_train_step: the noise (global B, L) is the global batch's, the
    loss returned too."""
    with span("pretrain.step"):
        B = x.shape[0]
        noise = _rank_noise(noise, (B, math.prod(student.fmap)), generator, x.device,
                            grad_accum_steps)
        with span("pretrain.update"):
            optimizer.zero_grad(set_to_none=False)
        losses = []
        for sl in _microbatches(B, grad_accum_steps):
            with span("pretrain.student_forward"):
                active = random_keep_mask(sl.stop - sl.start, student.fmap, student.len_keep,
                                          noise=noise[sl])
                inp, rec = student(x[sl], active)
                loss = spark_loss(inp, rec, active)[0]
            with span("pretrain.backward"):
                loss.backward()
            losses.append(loss.detach())
        with span("pretrain.update"):
            return _update(student, optimizer, grad_accum_steps, lr, grad_clip,
                           torch.stack(losses).mean())


@torch.no_grad()
def val_step(model: SparK, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reconstruction loss of x under a fresh random mask, no gradient."""
    active = random_keep_mask(x.shape[0], model.fmap, model.len_keep, generator,
                              device=x.device, noise=noise)
    inp, rec = model(x, active)
    return spark_loss(inp, rec, active)[0]


def _host_copy(obj):
    """The same structure with every tensor copied to the host. The optimizer
    and the EMA update write in place, so a checkpoint writer thread must be
    handed copies taken before it starts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class PretrainTrainer:
    """The pretraining loop on one GPU (`device="cpu"` runs every kernel's
    plain version instead), or on one rank of a process group
    (`parallel/mesh.py`; `atk_torch_pretrain -num_gpus N`), as JAX's
    multi-host run: the global batch scaled to a multiple of the ranks, each
    rank sampling its share (its oversample fraction, seed + 131071 * rank)
    through the host pipeline unless `device_cache` says otherwise, the
    augmentation and mask draws the global batch's, validation losses
    averaged over the ranks; rank 0 alone unpacks, writes the split, logs,
    plots and checkpoints, and every rank resumes from its checkpoint."""

    def __init__(
        self,
        dataset_name_or_id,
        config: PretrainConfig = PretrainConfig(),
        plans_identifier: str = "ATKPlans",
        configuration: str = "3d_fullres",
        fold: int = 0,
        output_folder: Optional[str] = None,
        device="cuda",
    ):
        from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
        self.cfg = config
        self.device = resolve_device(device)
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        pp_base = os.path.join(require("preprocessed"), self.dataset_name)
        self.plans_manager = PlansManager(os.path.join(pp_base, plans_identifier + ".json"))
        self.configuration_manager = self.plans_manager.get_configuration(configuration)
        self.dataset_json = load_json(os.path.join(pp_base, "dataset.json"))
        self.preprocessed_folder = os.path.join(pp_base,
                                                self.configuration_manager.data_identifier)
        self.fold = fold
        self.output_folder = output_folder or os.path.join(
            require("results"), self.dataset_name, f"pretrain_{config.method}_{config.model_size}")
        os.makedirs(self.output_folder, exist_ok=True)
        self.label_manager = self.plans_manager.get_label_manager(self.dataset_json)
        self.num_input_channels = len(
            self.dataset_json.get("channel_names", self.dataset_json.get("modality")))
        self.model = build_spark_model(config, self.num_input_channels, self.device,
                                       torch.Generator().manual_seed(config.seed))
        self.dtype = self.model.dtype
        self.current_epoch = 0
        self.epoch_timings: List[dict] = []  # seconds per epoch, as the log line prints
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_error: Optional[BaseException] = None

    def print_to_log_file(self, *args):
        if mesh.rank() != 0:
            return
        line = " ".join(str(a) for a in args)
        print(line, flush=True)
        with open(os.path.join(self.output_folder, "pretrain_log.txt"), "a") as f:
            f.write(line + "\n")

    # --- data -----------------------------------------------------------------
    def _split_keys(self) -> Tuple[List[str], List[str]]:
        """Fold train keys, then an internal train/val split of them (nnU-Net
        pretraining's train_test_split(test_size=0.15, random_state=42))."""
        all_keys = sorted(CaseDataset(self.preprocessed_folder).keys())
        splits_file = os.path.join(os.path.dirname(self.preprocessed_folder),
                                   "splits_final.json")
        if os.path.isfile(splits_file):
            splits = load_json(splits_file)
        else:
            splits = generate_crossval_split(all_keys, 5, seed=12345)
            if mesh.rank() == 0:
                save_json(splits, splits_file)
        tr_keys = splits[self.fold]["train"] if self.fold < len(splits) else all_keys
        rng = np.random.RandomState(self.cfg.seed)
        idx = rng.permutation(len(tr_keys))
        n_val = max(1, int(round(len(tr_keys) * self.cfg.val_fraction)))
        val = [tr_keys[i] for i in idx[:n_val]]
        train = [tr_keys[i] for i in idx[n_val:]]
        return train, val

    def get_dataloaders(self):
        cfg = self.cfg
        train_keys, val_keys = self._split_keys()
        ds_tr = CaseDataset(self.preprocessed_folder, train_keys)
        ds_val = CaseDataset(self.preprocessed_folder, val_keys)
        patch = tuple(cfg.patch_size)
        # spatial-only augmentation (rotation +-30deg, scaling .7-1.4,
        # mirroring; intensity transforms off)
        rot, dummy_2d, initial_patch, mirror_axes = rotation_ranges_and_initial_patch_size(patch)
        initial_patch = tuple(int(i) for i in initial_patch)
        self.aug_config = AugmentConfig(
            spatial=SpatialAugmentConfig(
                patch_size=patch, rotation_x=tuple(rot["x"]), rotation_y=tuple(rot["y"]),
                rotation_z=tuple(rot["z"]), dummy_2d=dummy_2d),
            intensity=IntensityAugmentConfig(
                p_noise=0, p_blur=0, p_brightness=0, p_contrast=0, p_lowres=0,
                p_gamma=0, p_gamma_invert=0),
            mirror_axes=mirror_axes,
            ds_scales=(),
        )
        annotated_key = tuple(self.label_manager.all_labels)
        has_ignore = self.label_manager.has_ignore_label
        self.global_batch = mesh.global_batch_size(cfg.batch_size, mesh.world(),
                                                   self.print_to_log_file)
        bs, os_pct = mesh.shard_batch_spec(self.global_batch, cfg.oversample_foreground_percent)
        seed = cfg.seed + 131071 * mesh.rank()
        self.sampler_train = PatchSampler(
            ds_tr, bs, initial_patch, final_patch_size=patch,
            oversample_foreground_percent=os_pct, annotated_classes_key=annotated_key,
            has_ignore=has_ignore, seed=seed,
            load_seg=False)  # labels only steer oversampling
        self.sampler_val = PatchSampler(
            ds_val, bs, patch, final_patch_size=patch,
            oversample_foreground_percent=os_pct, annotated_classes_key=annotated_key,
            has_ignore=has_ignore, seed=seed + 1, load_seg=False)
        n_workers = (cfg.num_workers if cfg.num_workers is not None
                     else min(4, get_allowed_n_proc_DA()))
        cache_dtype = self.dtype
        self.device_cache = self.device_cache_val = None
        use_cache = (cfg.device_cache if cfg.device_cache is not None
                     else mesh.world() == 1 and os.environ.get("ATK_DEVICE_CACHE", "1") == "1")
        if use_cache:
            self.device_cache = DeviceCaseCache(
                ds_tr, initial_patch=initial_patch, final_patch=patch,
                capacity_mb=cfg.device_cache_mb, oversample_foreground_percent=os_pct,
                annotated_classes_key=annotated_key, has_ignore=has_ignore,
                batch_size=bs, dtype=cache_dtype, seed=cfg.seed + 77,
                whole_dataset_mode=True, device=self.device)
            if self.device_cache.whole_dataset_resident:
                self.print_to_log_file("[device-cache] whole training set resident; refills off")
            else:
                # turnover target: each slot refreshed about once per epoch
                iters_hint = cfg.iters_per_epoch or 250
                self.device_cache.start_refill(
                    steps_per_slot=max(1, iters_hint // self.device_cache.num_slots))
            self.print_to_log_file(
                f"[device-cache] {self.device_cache.num_slots} slots of "
                f"{self.device_cache.slot_shape} on {self.device} "
                f"(~{cfg.device_cache_mb} MB budget); host sends only "
                f"(slot, origin) pairs per step")
            # validation patches come out of device memory too
            self.device_cache_val = DeviceCaseCache(
                ds_val, initial_patch=patch, final_patch=patch,
                capacity_mb=max(128, cfg.device_cache_mb // 4),
                oversample_foreground_percent=os_pct, annotated_classes_key=annotated_key,
                has_ignore=has_ignore, batch_size=bs, dtype=cache_dtype,
                seed=cfg.seed + 78, whole_dataset_mode=True, device=self.device)
            if not self.device_cache_val.whole_dataset_resident:
                # best-checkpoint selection then scores a rotating window of
                # the val cases, not the whole split
                self.print_to_log_file(
                    "[device-cache] WARNING: val cache holds "
                    f"{self.device_cache_val.num_slots} of {len(ds_val)} val cases - val "
                    "loss samples a rotating window, not the full split; raise "
                    "device_cache_mb to make best-checkpoint selection window-independent")
                self.device_cache_val.start_refill(steps_per_slot=max(
                    1, max(1, (cfg.iters_per_epoch or 250) // 5)
                    // self.device_cache_val.num_slots))
        transfer_dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        self.loader_train = PrefetchPipeline(
            self.sampler_train,
            num_workers=1 if self.device_cache is not None else n_workers,
            device=self.device, transfer_dtype=transfer_dtype, drop_keys=("seg",))
        self.loader_val = PrefetchPipeline(self.sampler_val, num_workers=1,
                                           device=self.device, drop_keys=("seg",))
        self.n_train = len(train_keys)
        return self.loader_train, self.loader_val

    # --- initialization -------------------------------------------------------
    def initialize(self):
        cfg = self.cfg
        self.teacher = self.model if cfg.method == "spark" else make_teacher(self.model)
        self.optimizer = make_optimizer(self.model, cfg)
        self.grad_accum_steps = accumulation_steps(self.global_batch, cfg.grad_accum_steps,
                                                   mesh.world())
        if self.grad_accum_steps != cfg.grad_accum_steps:
            self.print_to_log_file(f"[accum] grad_accum_steps adjusted {cfg.grad_accum_steps} -> "
                                   f"{self.grad_accum_steps} (global batch {self.global_batch}, "
                                   f"{mesh.world()} ranks)")
        iters = cfg.iters_per_epoch or max(1, getattr(self, "n_train", 100) // cfg.batch_size)
        self.iters_per_epoch = iters
        self.lr_schedule = linear_warmup_cosine_schedule(
            cfg.lr, warmup_steps=cfg.warmup_epochs * iters, total_steps=cfg.num_epochs * iters,
            warmup_start_lr=1e-6)
        self.augment = make_train_augment_fn(self.aug_config)
        # augmentation parameters are drawn on the host, masks on the device
        self.aug_generator = torch.Generator().manual_seed(cfg.seed + 999)
        self.mask_generator = torch.Generator(self.device).manual_seed(cfg.seed + 999)
        self.step_counter = 0
        self.fetch_wait_s = 0.0  # waiting for the loader or the case cache (next_batch)

    def epoch_settings(self, epoch: int) -> Tuple[float, float, int]:
        """(teacher EMA decay, guided keep ratio, len_loss) of an epoch:
        the decay ramps ema_decay_start -> ema_decay_end over the first quarter
        of the epochs,
        and the len_loss hardest patches of the masked ones are forced."""
        cfg = self.cfg
        ema_decay = ema_decay_schedule(epoch, cfg.num_epochs, cfg.ema_decay_start,
                                       cfg.ema_decay_end)
        keep_ratio = guided_keep_ratio(epoch, cfg.num_epochs, cfg.guide)
        L = math.prod(self.model.fmap)
        return ema_decay, keep_ratio, int((L - self.model.len_keep) * keep_ratio)

    def _optimizer_count(self) -> int:
        """The optimizer's step count, optax's `count`: the LR of a step is the
        schedule at the count before its update."""
        state = self.optimizer.state.get(self.optimizer.param_groups[0]["params"][0])
        return int(state["step"]) if state else 0

    def _to_model(self, data: torch.Tensor) -> torch.Tensor:
        """(B, x, y, z, C) -> the model's (B, C, x, y, z) in the compute dtype,
        channels_last_3d memory."""
        return data.to(self.dtype).permute(0, 4, 1, 2, 3).contiguous(
            memory_format=torch.channels_last_3d)

    def _prep(self, data: torch.Tensor) -> torch.Tensor:
        """The batch augmented with the global batch's draws (this rank's
        rows: its share of every microbatch)."""
        if (self.aug_config.spatial.p_rotation > 0
                or tuple(data.shape[1:4]) != tuple(self.cfg.patch_size)):
            data, _ = self.augment(self.aug_generator, data,
                                   rows=mesh.local_rows(self.global_batch, self.grad_accum_steps),
                                   global_batch=self.global_batch)
        return self._to_model(data)

    # --- checkpointing --------------------------------------------------------
    def _snapshot_state(self) -> dict:
        """One host copy of the training state (student, teacher, AdamW)."""
        net = _host_copy(self.model.state_dict())
        return {
            "network_weights": net,
            "ema_weights": net if self.teacher is self.model
            else _host_copy(self.teacher.state_dict()),
            "optimizer_state": _host_copy(self.optimizer.state_dict()),
        }

    def _checkpoint_meta(self, extra_meta: Optional[dict] = None) -> dict:
        meta = {
            "method": self.cfg.method,
            "model_size": self.cfg.model_size,
            "current_epoch": self.current_epoch + 1,
            "spark_config": self.model.get_config(),
            "pretrain_config": {k: (list(v) if isinstance(v, tuple) else v)
                                for k, v in asdict(self.cfg).items()},
        }
        meta.update(extra_meta or {})
        return meta

    def _join_ckpt_writer(self):
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
            err, self._ckpt_error = self._ckpt_error, None
            if err is not None:
                raise RuntimeError("background checkpoint write failed") from err

    def _write_checkpoints_async(self, filenames, state, meta):
        """`state` written once, under filenames[0], on a background thread
        so that serialisation overlaps the next epoch's steps; the other names
        become links to that file (one snapshot, one file: a STUNet-H
        checkpoint is 12.8 GB). `state` holds host copies taken before the
        thread starts. At most one writer is outstanding; a failed write is
        re-raised at the next join. Rank 0 alone writes."""
        if mesh.rank() != 0:
            return
        self._join_ckpt_writer()
        paths = [os.path.join(self.output_folder, f) for f in filenames]

        def write():
            try:
                ckpt_lib.save_trainer_checkpoint(paths[0], state, meta)
                for path in paths[1:]:
                    ckpt_lib.link_checkpoint(paths[0], path)
            except BaseException as e:  # re-raised in _join_ckpt_writer
                self._ckpt_error = e
                self.print_to_log_file(f"CHECKPOINT WRITE FAILED: {e!r}")

        self._ckpt_thread = threading.Thread(target=write, daemon=True)
        self._ckpt_thread.start()

    def save_checkpoint(self, filename: str, extra_meta: Optional[dict] = None,
                        state: Optional[dict] = None):
        if mesh.rank() != 0:
            return  # the ranks' weights are identical: rank 0 writes for all
        self._join_ckpt_writer()
        if state is None:
            state = self._snapshot_state()
        ckpt_lib.save_trainer_checkpoint(os.path.join(self.output_folder, filename), state,
                                         self._checkpoint_meta(extra_meta))

    def load_checkpoint(self, filename: str):
        self._join_ckpt_writer()
        path = filename if os.path.isabs(filename) else os.path.join(self.output_folder,
                                                                     filename)
        state, meta = ckpt_lib.load_trainer_checkpoint(path)
        # the architecture must match (the reference SparK.load_state_dict check)
        saved_cfg = meta.get("spark_config", {})
        for k, v in self.model.get_config().items():
            if k in saved_cfg and saved_cfg[k] != v:
                raise AttributeError(
                    f"SparK config mismatch on load: this.{k}={v} ckpt.{k}={saved_cfg[k]}")
        self.model.load_state_dict(state["network_weights"])
        if "ema_weights" in state and self.teacher is not self.model:
            self.teacher.load_state_dict(state["ema_weights"])
        if "optimizer_state" in state:
            self.optimizer.load_state_dict(state["optimizer_state"])
        self.current_epoch = meta.get("current_epoch", 0)

    # --- training loop --------------------------------------------------------
    def _train_batch(self, train_iter) -> torch.Tensor:
        if self.device_cache is not None:
            # GPU-resident path: the host draws (slot, origin) pairs, the batch
            # never crosses the host link; one staged refill between steps
            self.device_cache.maybe_refill()
            slots, origins = self.device_cache.sample_batch()
            return self.device_cache.extract(slots, origins)
        return next(train_iter)["data"]

    def stop_data(self):
        """Stop the loaders' workers and the case caches' refills."""
        self.loader_train.stop()
        self.loader_val.stop()
        for cache in (self.device_cache, self.device_cache_val):
            if cache is not None:
                cache.stop()

    def next_batch(self, train_iter=None) -> torch.Tensor:
        """The next training batch as a step takes it, under the span
        `pretrain.data`: a sample of the case cache, else `train_iter`'s next,
        augmented, in the model's dtype and layout. The wait for the cache or
        the loader adds to `fetch_wait_s`."""
        with span("pretrain.data"):
            f0 = time.time()
            data = self._train_batch(train_iter)
            self.fetch_wait_s += time.time() - f0
            return self._prep(data)

    def train_step(self, x: torch.Tensor, len_loss: int, ema_decay: float):
        """One step of cfg.method on the batch x at the schedule's LR (the
        optimizer's count). Returns (loss, hard mask, teacher's loss map):
        anatomask_train_step's, or the SparK step's loss and two Nones."""
        cfg = self.cfg
        kw = dict(lr=self.lr_schedule(self._optimizer_count()), grad_clip=cfg.grad_clip,
                  grad_accum_steps=self.grad_accum_steps)
        if cfg.method == "spark":
            out = (spark_train_step(self.model, self.optimizer, x, self.mask_generator, **kw),
                   None, None)
        else:
            out = anatomask_train_step(self.model, self.teacher, self.optimizer, x, len_loss,
                                       self.mask_generator, ema_decay=ema_decay, **kw)
        self.step_counter += 1
        return out

    def _val_losses(self, n_val: int, val_iter) -> List[torch.Tensor]:
        if self.device_cache_val is None:
            return [val_step(self.model, self._to_model(next(val_iter)["data"]),
                             self.mask_generator) for _ in range(n_val)]
        slots, origins = self.device_cache_val.sample_chunk(n_val)
        losses = [val_step(self.model, self._to_model(self.device_cache_val.extract(s, o)),
                           self.mask_generator) for s, o in zip(slots, origins)]
        self.device_cache_val.maybe_refill(n_val)
        return losses

    def run_pretraining(self, continue_training: bool = False):
        if mesh.rank() == 0:
            unpack_dataset(self.preprocessed_folder,
                           num_processes=min(4, get_allowed_n_proc_DA()))
            self._split_keys()  # writes splits_final.json where it is missing
        mesh.barrier()
        self.get_dataloaders()
        self.initialize()
        if continue_training:
            latest = os.path.join(self.output_folder, "checkpoint_latest.pt")
            if os.path.isfile(latest):
                self.load_checkpoint(latest)
                self.print_to_log_file(f"resumed at epoch {self.current_epoch}")

        cfg = self.cfg
        train_iter = iter(self.loader_train) if self.device_cache is None else None
        val_iter = iter(self.loader_val) if self.device_cache_val is None else None
        history = {"train_loss": [], "val_loss": [], "ema_loss": []}
        best_val = np.inf
        last_saved = None  # (file name, step count) of the last epoch's checkpoint
        ema_loss = None

        try:
            for epoch in range(self.current_epoch, cfg.num_epochs):
                self.current_epoch = epoch
                t0 = time.time()
                ema_decay, keep_ratio, len_loss = self.epoch_settings(epoch)

                fetch0 = self.fetch_wait_s
                losses = [self.train_step(self.next_batch(train_iter), len_loss, ema_decay)[0]
                          for _ in range(self.iters_per_epoch)]
                t_fetch = self.fetch_wait_s - fetch0
                train_loss = torch.stack(losses).float().mean().item()
                t_train = time.time() - t0
                if not np.isfinite(train_loss):
                    raise RuntimeError(f"Non-finite pretrain loss at epoch {epoch}: {train_loss}")
                # epoch EMA loss, alpha 0.9
                ema_loss = train_loss if ema_loss is None else 0.9 * ema_loss + 0.1 * train_loss

                # validation loss under a fresh random mask
                tv0 = time.time()
                n_val = max(1, self.iters_per_epoch // 5)
                val_loss = mesh.mean_over_ranks(
                    torch.stack(self._val_losses(n_val, val_iter)).float().mean()).item()
                t_val = time.time() - tv0

                history["train_loss"].append(train_loss)
                history["val_loss"].append(val_loss)
                history["ema_loss"].append(ema_loss)

                # one host snapshot per epoch, written once (latest, else
                # best) on a thread that overlaps the next epoch's steps; the
                # head and the best are links to it. Its metadata holds the
                # epoch's val_loss, which JAX writes into the best's only.
                tc0 = time.time()
                need_latest = (epoch + 1) % cfg.save_every == 0
                is_best = val_loss < best_val
                if is_best:
                    best_val = val_loss
                if need_latest or is_best:
                    names = ((["checkpoint_latest.pt", f"{cfg.model_size}_head_latest.pt"]
                              if need_latest else []) + (["checkpoint_best.pt"] if is_best else []))
                    self._write_checkpoints_async(
                        names, self._snapshot_state(),
                        self._checkpoint_meta({"val_loss": val_loss}))
                    last_saved = (names[0], self.step_counter)
                t_ckpt = time.time() - tc0
                if mesh.rank() == 0:
                    self._plot_progress(history)
                t_epoch = time.time() - t0
                self.epoch_timings.append(dict(epoch=epoch, total=t_epoch, train=t_train,
                                               fetch_wait=t_fetch, val=t_val, ckpt=t_ckpt))
                self.print_to_log_file(
                    f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
                    f"ema {ema_loss:.4f} keep_ratio {keep_ratio:.3f} "
                    f"time {t_epoch:.1f}s "
                    f"(train {t_train:.1f}s [fetch-wait {t_fetch:.1f}s] "
                    f"val {t_val:.1f}s ckpt {t_ckpt:.1f}s)")
        finally:
            self._join_ckpt_writer()
            self.stop_data()
        if mesh.rank() != 0:
            return history
        if last_saved is not None and last_saved[1] == self.step_counter:
            # no step since the last epoch's checkpoint: the final one is it
            ckpt_lib.link_checkpoint(os.path.join(self.output_folder, last_saved[0]),
                                     os.path.join(self.output_folder, "checkpoint_final.pt"))
        else:
            self.save_checkpoint("checkpoint_final.pt")
        with open(os.path.join(self.output_folder, "history.json"), "w") as f:
            json.dump(history, f)
        return history

    def _plot_progress(self, history):
        """progress.png of the three loss curves; skipped without matplotlib."""
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(history["train_loss"], label="train")
        ax.plot(history["val_loss"], label="val")
        ax.plot(history["ema_loss"], label="train (EMA)")
        ax.set_xlabel("epoch")
        ax.set_ylabel("recon loss")
        ax.legend()
        fig.savefig(os.path.join(self.output_folder, "progress.png"))
        plt.close(fig)


def load_ssl_encoder_into_trainer(trainer, checkpoint: str, verbose: bool = True):
    """The pretrained sparse encoder of `checkpoint` into the supervised
    `trainer`'s STUNet (`training/checkpoint.py` `transfer_ssl_encoder_weights`):
    a JAX pretraining checkpoint (.npz, the `sparse_encoder` subtree of its
    network_weights) or this module's PretrainTrainer's (.pt, the student's
    state_dict). Initializes the trainer first if it has no network yet."""
    if checkpoint.endswith(".npz"):
        arrays, _ = ckpt_lib.load_checkpoint(checkpoint)
        params = arrays.get("network_weights", arrays)
        encoder = stunet_state_dict_from_jax(params.get("sparse_encoder", params))
    else:
        state, _ = ckpt_lib.load_trainer_checkpoint(checkpoint)
        encoder = state["network_weights"]
    if trainer.network is None:
        trainer.initialize()
    trainer.network.load_state_dict(ckpt_lib.transfer_ssl_encoder_weights(
        trainer.network.state_dict(), encoder, verbose=verbose))
    return trainer

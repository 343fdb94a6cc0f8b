"""AnatoMask teacher-student pretraining step. Counterpart of the step that
anatomask_tpu/ssl/pretrain.py builds and bench.py times (one microbatch):

1. the EMA teacher reconstructs under a random mask (no_grad);
2. its per-patch loss picks the hard mask (`generate_guided_mask`);
3. the student runs forward and backward under the hard mask;
4. global-norm clip, then AdamW on the student;
5. EMA update of the teacher.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn as nn

from anatomask_torch.device import resolve_device
from anatomask_torch.ssl.anatomask import generate_guided_mask
from anatomask_torch.ssl.decoder import LightDecoder
from anatomask_torch.ssl.ema import ema_update
from anatomask_torch.ssl.spark import SparK, random_keep_mask, spark_loss
from anatomask_torch.ssl.sparse import SparseSTUNetEncoder

STUNET_B_DIMS = (32, 64, 128, 256, 512)
# bench.py's optimizer and teacher constants
LR, WEIGHT_DECAY = 1e-4, 1e-5
GRAD_CLIP = 12.0
EMA_DECAY = 0.999


@dataclass(frozen=True)
class PretrainConfig:
    """The fields of anatomask_tpu's PretrainConfig that building the model
    reads. The encoder is STUNet-B (one block a stage); the decoder is as wide
    as the encoder's top stage; densify and decoder norms are "in"."""
    patch_size: Tuple[int, int, int] = (112, 112, 128)
    compute_dtype: str = "bfloat16"
    encoder_dims: Tuple[int, ...] = STUNET_B_DIMS


def build_spark_model(cfg: PretrainConfig, in_channels: int = 1, device="cuda",
                      generator: Optional[torch.Generator] = None) -> SparK:
    """STUNet sparse encoder + LightDecoder SparK, initialised on the CPU from
    `generator` (default: seed 0), then moved to `device`."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    enc = SparseSTUNetEncoder(in_channels, cfg.encoder_dims, dtype, generator)
    dec = LightDecoder(enc.get_downsample_ratio(), cfg.encoder_dims[-1], in_channels, dtype,
                       generator)
    model = SparK(enc, dec, cfg.patch_size, dtype, generator)
    return model.to(device)


def make_teacher(student: nn.Module) -> nn.Module:
    """A frozen copy of the student, for the EMA updates."""
    return copy.deepcopy(student).requires_grad_(False)


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """name -> True where weight decay applies: not on mask tokens (5-D here,
    so excluded by name), biases, or 1-D parameters such as norm weights."""
    return {name: "mask_token" not in name and "bias" not in name and p.ndim > 1
            for name, p in model.named_parameters()}


def make_optimizer(model: nn.Module) -> torch.optim.AdamW:
    """AdamW(1e-4, wd 1e-5, betas 0.9/0.999, eps 1e-8) with decay where
    no_decay_mask says."""
    decay = no_decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [p for n, p in params.items() if decay[n]], "weight_decay": WEIGHT_DECAY},
        {"params": [p for n, p in params.items() if not decay[n]], "weight_decay": 0.0},
    ]
    return torch.optim.AdamW(groups, lr=LR, betas=(0.9, 0.999), eps=1e-8)


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm: where the global norm is >= max_norm, every
    gradient becomes g / norm * max_norm. (torch's clip_grad_norm_ adds 1e-6 to
    the norm.) Runs on the device without a host sync; returns the norm."""
    grads = list(grads)
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm


def anatomask_train_step(student: SparK, teacher: SparK, optimizer: torch.optim.Optimizer,
                         x: torch.Tensor, len_loss: int,
                         generator: Optional[torch.Generator] = None, *,
                         noise: Optional[torch.Tensor] = None):
    """One AnatoMask step on x (B, C, H, W, D). The two (B, L) uniform draws
    (random teacher mask, guided-mask noise) come from `generator`, or from
    `noise` (2, B, L) where a test supplies them. Returns (student loss, hard
    mask, teacher per-patch loss map)."""
    B = x.shape[0]
    L = math.prod(student.fmap)
    if noise is None:
        noise = torch.rand((2, B, L), generator=generator, device=x.device)
    with torch.no_grad():
        mask1 = random_keep_mask(B, student.fmap, student.len_keep, noise=noise[0])
        inp1, rec1 = teacher(x, mask1)
        _, loss_map = spark_loss(inp1, rec1, mask1)
        hard, _ = generate_guided_mask(loss_map, student.fmap, student.len_keep,
                                       len_loss, noise=noise[1])

    optimizer.zero_grad(set_to_none=False)
    inp, rec = student(x, hard)
    loss = spark_loss(inp, rec, hard)[0]
    loss.backward()
    params = list(student.parameters())
    for p in params:  # unread parameters get zero gradients, as in JAX
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in params], GRAD_CLIP)
    optimizer.step()
    ema_update(teacher, student, EMA_DECAY)
    return loss.detach(), hard, loss_map

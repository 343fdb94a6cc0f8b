"""The AnatoMask step of the plain references, for any SparK forward: the
teacher's reconstruction under a random mask, its per-patch loss, the
teacher-guided hard mask, the student's loss and gradient sample by sample,
AdamW after the global-norm clip, the EMA teacher.

It is `reference/stunet.py`'s `anatomask_steps` with two arguments more:
the SparK forward (`forward(P, cfg, x, active, q)`, STUNet's or MedNeXt's)
and each step's learning rate (a trainer's schedule moves it from step to
step). The loss, the masks and AdamW are `reference/stunet.py`'s, imported.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from benchmark.reference.stunet import (EXACT, AdamW, Params, Quant, forced_patches,
                                        guided_mask, keep_lowest, spark_loss)


def anatomask_steps(forward: Callable, P0: Params, cfg: dict, batches: Sequence[torch.Tensor],
                    noises: Sequence[torch.Tensor], len_loss: int, ema_decay: float,
                    hard_masks: Optional[Sequence[torch.Tensor]] = None, q: Quant = EXACT,
                    batch_fraction: float = 1.0, lrs: Optional[Sequence[float]] = None) -> dict:
    """AnatoMask steps from the weights P0 (teacher = student = P0): for each
    batch x (B, C, X, Y, Z) and its uniforms noise (2, B, L), the teacher's
    reconstruction under the random mask of noise[0], its per-patch loss,
    the hard mask (from `hard_masks[k]` where given, else from the forced
    patches and noise[1]), the student's loss and gradient sample by sample,
    AdamW after the clip at `lrs[k]` (default the configuration's lr), the
    EMA. `batch_fraction` < 1 takes the student's loss over that leading
    share of the batch alone (a fault).

    Returns the record the benchmark compares: each step's loss, loss map
    and hard mask, the first step's clipped gradients, and the student's
    and the teacher's weights after the last step."""
    p = cfg["pretrain"]
    fmap = [s >> (p["encoder_stages"] - 1) for s in p["patch_size"]]
    L = math.prod(fmap)
    len_keep = round(L * (1 - p["mask_ratio"]))
    student = {n: t.detach().clone().float() for n, t in P0.items()}
    teacher = {n: t.clone() for n, t in student.items()}
    opt = AdamW(student, p["lr"], p["weight_decay"], p["grad_clip"])
    rec = {"loss": [], "loss_map": [], "hard": [], "grad": None}
    for k, (x, noise) in enumerate(zip(batches, noises)):
        B = x.shape[0]
        n_used = max(1, int(B * batch_fraction))
        grads = {n: torch.zeros_like(t) for n, t in student.items()}
        losses, maps, hards = [], [], []
        for i in range(B):
            xi = x[i:i + 1].float()
            with torch.no_grad():
                mask1 = keep_lowest(noise[0, i:i + 1], len_keep, fmap)
                _, lm = spark_loss(*forward(teacher, cfg, xi, mask1, q), mask1)
                if hard_masks is None:
                    hard = guided_mask(forced_patches(lm, len_loss), noise[1, i:i + 1],
                                       len_keep, fmap)
                else:
                    hard = hard_masks[k][i:i + 1].reshape(1, 1, *fmap)
            maps.append(lm)
            hards.append(hard)
            with torch.set_grad_enabled(i < n_used):
                leaves = {n: t.requires_grad_(i < n_used) for n, t in student.items()}
                loss = spark_loss(*forward(leaves, cfg, xi, hard, q), hard)[0]
            if i < n_used:
                g = torch.autograd.grad(loss / n_used, list(leaves.values()), allow_unused=True)
                for (n, acc), gi in zip(grads.items(), g):
                    if gi is not None:
                        acc.add_(gi)
            losses.append(loss.detach())
            for t in student.values():
                t.requires_grad_(False)
        if lrs is not None:
            opt.lr = lrs[k]
        clipped = opt.step(student, grads)
        if k == 0:
            rec["grad"] = clipped
        with torch.no_grad():
            for n, t in teacher.items():
                t.lerp_(student[n], 1.0 - ema_decay)
        rec["loss"].append(torch.stack(losses[:n_used]).mean())
        rec["loss_map"].append(torch.cat(maps))
        rec["hard"].append(torch.cat(hards).reshape(B, L))
    rec["student"], rec["teacher"] = student, teacher
    return rec

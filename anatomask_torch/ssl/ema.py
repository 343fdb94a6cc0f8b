"""EMA teacher. Counterpart of anatomask_tpu/ssl/ema.py.

The teacher is a second module of the same structure; the update runs in
place under no_grad (the JAX package returns a new tree instead).
"""
from __future__ import annotations

import torch
import torch.nn as nn


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, decay: float) -> None:
    """teacher <- decay * teacher + (1 - decay) * student, parameter by parameter."""
    for e, p in zip(teacher.parameters(), student.parameters(), strict=True):
        e.lerp_(p.to(e.dtype), 1.0 - decay)


def ema_decay_schedule(epoch, total_epochs: int, start: float = 0.999,
                       end: float = 0.9999, warmup_fraction: float = 0.25) -> float:
    """Linear ramp from start to end over the first quarter of the epochs."""
    warm = max(1, int(total_epochs * warmup_fraction))
    frac = min(1.0, epoch / warm)
    return start + (end - start) * frac

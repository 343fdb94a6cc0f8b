"""LR schedules as functions of the step counter that return Python floats.
Counterpart of anatomask_tpu/training/schedules.py (`linear_warmup_cosine_schedule`,
`poly_lr_schedule`, `cosine_annealing_schedule`), which computes them in fp32
with jnp."""
from __future__ import annotations

import math


def poly_lr_schedule(initial_lr: float, max_steps: int, exponent: float = 0.9):
    def schedule(step) -> float:
        frac = min(max(float(step) / max_steps, 0.0), 1.0)
        return initial_lr * (1 - frac) ** exponent
    return schedule


def linear_warmup_cosine_schedule(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    warmup_start_lr: float = 1e-6,
    eta_min: float = 0.0,
):
    """Linear warmup from warmup_start_lr to base_lr over warmup_steps, then
    cosine to eta_min at total_steps."""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return warmup_start_lr + (base_lr - warmup_start_lr) * (step / max(1, warmup_steps))
        progress = min(max((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * progress))
    return schedule


def cosine_annealing_schedule(base_lr: float, total_steps: int, eta_min: float = 0.0):
    def schedule(step) -> float:
        progress = min(max(float(step) / max(1, total_steps), 0.0), 1.0)
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * progress))
    return schedule

"""Tiny cells on the CPU for the benchmark's tests: each cell's files as
they are, with STUNet-S widths at a 32^3 patch (pretraining: batch 2, two
checked steps) and a 1x40x36x34 volume (prediction: one mirror axis), run
through the port's CPU path (every kernel's plain version)."""
from __future__ import annotations

import copy
import time

import pytest

from benchmark import harness


def tiny_spec(workload: str, dtype: str = "float32", root=harness.ROOT) -> harness.Spec:
    spec = harness.load_spec(workload, root)
    cfg = copy.deepcopy(spec.config)
    cfg.update(compute_dtype=dtype, model_size="S", stage_widths=[16, 32, 64, 128, 256, 256],
               blocks_per_stage=[1] * 6, checked_steps=2)
    cfg["pretrain"].update(decoder_width=256, patch_size=[32, 32, 32], grad_accum_steps=1,
                           remat=False)
    cfg["segmentation"] = dict(cfg.get("segmentation", {}), arch_name="STUNet-S",
                               patch_size=[32, 32, 32],
                               pool_op_kernel_sizes=[[1, 1, 1]] + [[2, 2, 2]] * 5,
                               conv_kernel_sizes=[[3, 3, 3]] * 6)
    traffic = dict(spec.traffic)
    if traffic["driver"] == "pretrain_step":
        traffic.update(batch=2, pool_batches=3)
    else:
        traffic.update(volume_shape=[1, 40, 36, 34], mirror_axes=[0], sample_span=2)
    return harness.Spec(spec.root, spec.manifest, spec.workload, cfg, traffic, spec.limits)


def run_tiny(spec: harness.Spec, seed: int = 2 ** 31 + 17, trace: bool = False) -> dict:
    return harness.run(spec, seed, 0.0, trace, "cpu", time.time(), log=lambda *a: None)


@pytest.fixture
def tiny():
    return tiny_spec

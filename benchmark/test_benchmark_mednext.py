"""The MedNeXt cell tiny on the CPU: the configuration's files as they are,
at widths 4-64 (the port's blocks, expansion and kernel) on a 32^3 patch,
batch 2, two checked steps, through the port's CPU path; correct in float32
against `reference/mednext.py`, and the float8 control not correct. The
yardstick's depthwise count matches the shapes."""
import copy
import json

import pytest
import torch

from benchmark import harness
from benchmark.conftest import run_tiny
from benchmark.reference import stunet
from benchmark.yardstick import mednext as yardstick

CELL = "pretrain-mednext.anatomask"


def tiny_mednext(dtype: str = "float32") -> harness.Spec:
    spec = harness.load_spec(CELL)
    cfg = copy.deepcopy(spec.config)
    cfg.update(compute_dtype=dtype, stage_widths=[4, 8, 16, 32, 64], checked_steps=2)
    cfg["pretrain"].update(decoder_width=64, patch_size=[32, 32, 32])
    traffic = dict(spec.traffic, batch=2, pool_batches=3, trace_seconds=0.0)
    return harness.Spec(spec.root, spec.manifest, spec.workload, cfg, traffic, spec.limits)


def test_tiny_cell_is_correct_and_reads_its_metrics():
    res = run_tiny(tiny_mednext(), trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2, res["checks"]
    assert set(res["metrics"]) <= {m["name"] for m in tiny_mednext().per_layer()}


def test_float8_control_is_not_correct():
    spec = tiny_mednext("bfloat16")
    cell = spec.driver().Cell(spec.config, spec.traffic, 2 ** 31 + 23, torch.device("cpu"))
    cell.stand_in(stunet.FP8)
    correct, checks = harness.judge(cell.check(), spec.limits)
    assert not correct, checks


def test_depthwise_count():
    cfg = json.loads((harness.ROOT / "benchmark/configs/mednext-k7.json").read_text())
    dense, dw = yardstick.encoder_convs(cfg)
    assert len(dw) == sum(cfg["blocks_per_stage"]) + 4
    # 0.40 TFLOP and 2.81 GB a forward of batch 4 at 2 bytes an element
    assert sum(d.flops(4) for d in dw) == pytest.approx(0.399e12, rel=1e-3)
    assert sum(d.nbytes(4, 2) for d in dw) == pytest.approx(2.806e9, rel=1e-3)
    work = yardstick.pretrain_step(cfg, 4, 989e12, 3.35e12, 2)
    assert work.depthwise_launches == 4 * len(dw)
    assert work.conv_launches == 3 * 11  # 3 densify and 8 decoder 3x3x3 convs, fwd x2 + dx

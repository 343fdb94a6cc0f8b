"""The trainer cell tiny on the CPU: its files as they are, with STUNet-S
widths at a 32^3 patch, batch 2, two checked iterations of PretrainTrainer
on 6 cases of 40x44x48 beside a two-slot case cache, through the port's CPU
path; correct, with the dataset folder gone afterwards. The readers of
`data_ms.train`, `depthwise_ms.train` and `depthwise_roofline.train` on a
synthetic trace: the data span beside the step, kernels found by their
whole name, nothing where nothing ran."""
import json
from types import SimpleNamespace

import pytest

from benchmark import harness, named_kernels, spans
from benchmark.conftest import run_tiny, tiny_spec
from benchmark.drivers import pretrain_trainer
from benchmark.test_benchmark_spans import EVENTS, ev, kernel, launch

CELL = "pretrain-B.trainer"


def tiny_trainer() -> harness.Spec:
    spec = tiny_spec(CELL)
    spec.traffic = dict(harness.load_spec(CELL).traffic, batch=2, cases=6,
                        case_shape=[1, 40, 44, 48], device_cache_mb=4, trace_seconds=0.0)
    return spec


def test_tiny_cell_is_correct_and_leaves_no_dataset():
    before = set(pretrain_trainer.OUT.glob("trainer-dataset-*"))
    res = run_tiny(tiny_trainer())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    assert set(pretrain_trainer.OUT.glob("trainer-dataset-*")) == before


DW = ("void at::native::(anonymous namespace)::conv_depthwise3d_cuda_kernel<c10::BFloat16, "
      "float, -1, -1, -1, 1, 1, 1>(x)")
TRAINER_EVENTS = [ev("pretrain.data", "user_annotation", -30.0, 25.0), launch(-28.0, 9),
                  kernel("void at::native::index_kernel<x>(y)", -27.0, 4.0, 9),
                  kernel(DW, 201.0, 30.0, 10), launch(199.0, 10),
                  kernel(DW.replace("cuda_kernel", "cuda_backward_weight_kernel"), 232.0, 10.0, 11),
                  launch(199.5, 11)] + EVENTS


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "OUT", tmp_path)
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": TRAINER_EVENTS}))
    work = SimpleNamespace(depthwise_bound_s=4e-6)
    return SimpleNamespace(workload="cell", unit="step", units=1, work=work)


def read(metric, ctx):
    return harness.load_module(harness.ROOT / "benchmark" / "metrics" / f"{metric}.py",
                               f"_m_{metric}").read(ctx)


def test_data_span_is_read_beside_the_step(ctx):
    # [-30, -5): its kernel [-27, -23) busy; idle the window's start [-28,
    # -27) and the gap [-23, 10) to the teacher's kernel, whose midpoint lies
    # in it; nothing of it inside the step's phases
    assert read("data_ms.train", ctx) == pytest.approx((4.0 + 1.0 + 33.0) * 1e-3)
    assert spans.phase_ms(ctx, "step", "pretrain.backward") == pytest.approx(0.096)


def test_depthwise_readers_match_whole_names(ctx):
    assert read("depthwise_ms.train", ctx) == pytest.approx(0.040)
    assert read("depthwise_roofline.train", ctx) == pytest.approx(10.0)
    ctx.work = SimpleNamespace(depthwise_bound_s=0.0)  # STUNet: no depthwise conv
    assert read("depthwise_roofline.train", ctx) is None


def test_depthwise_readers_give_nothing_without_the_kernels(ctx, tmp_path):
    (tmp_path / "bare.trace.json").write_text(json.dumps({"traceEvents": EVENTS}))
    for workload in ("bare", "no_trace"):
        ctx.workload = workload
        assert read("depthwise_ms.train", ctx) is None
        assert read("depthwise_roofline.train", ctx) is None
    assert named_kernels.device_s("bare", "conv3x3_wgmma") == pytest.approx(40e-6)

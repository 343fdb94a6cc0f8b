"""The phase split (`spans.py`) on a synthetic Chrome trace of one step: a
kernel launched from the autograd thread while the main thread waits in
`pretrain.backward` is the backward's, an overlap counts once (to the
operation that started first), each idle gap goes to the span open at its
midpoint, the phases and `rest` sum to the window and their busy parts to
`busy_s`, and a reader gives nothing on a unit-count mismatch or a phase
without a span."""
import json
from types import SimpleNamespace

import pytest

from benchmark import spans, trace

MAIN, AUTOGRAD = 1, 2


def ev(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, tid=MAIN):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 0.5, tid, corr)


def kernel(name, ts, dur, corr):
    return ev(name, "kernel", ts, dur, 7, corr)


EVENTS = [
    ev("pretrain.step", "user_annotation", 0.0, 200.0),
    ev("pretrain.teacher", "user_annotation", 8.0, 32.0),
    ev("pretrain.student_forward", "user_annotation", 40.0, 30.0),
    ev("pretrain.backward", "user_annotation", 70.0, 80.0),
    ev("pretrain.update", "user_annotation", 150.0, 40.0),
    # not a program span: the update's launches stay the update's
    ev("Optimizer.step#AdamW.step", "user_annotation", 158.0, 27.0),
    ev("Optimizer.step#AdamW.step", "gpu_user_annotation", 158.0, 30.0),
    ev("aten::empty", "cpu_op", 1.0, 1.0),
    launch(9.0, 1), launch(45.0, 2), launch(80.0, 3, AUTOGRAD), launch(155.0, 4),
    launch(160.0, 5),
    ev("cudaDeviceSynchronize", "cuda_runtime", 185.0, 13.0),
    kernel("void conv3x3_igemm::hopper::conv3x3_wgmma<64, 128, true>(x)", 10.0, 40.0, 1),
    # starts inside the teacher's kernel: [45, 50) is the teacher's
    kernel("void at::native::vectorized_elementwise_kernel<4>(x)", 45.0, 15.0, 2),
    kernel("wgrad_alg1_nd_float_engine<__nv_bfloat16>(x)", 90.0, 50.0, 3),
    kernel("void at::native::multi_tensor_apply_kernel<x>(y)", 156.0, 14.0, 4),
    ev("Memset (Device)", "gpu_memset", 175.0, 5.0, 7, 5),
]
# busy: teacher [10, 50) 40, student [50, 60) 10, backward [90, 140) 50,
# update [156, 170) + [175, 180) 19. Idle: [1, 10) at 5.5 in the step alone
# (rest); [60, 90) and [140, 156) in the backward; [170, 175), under 10 us,
# and [180, 198) in the update.
BUSY = {"pretrain.teacher": 40.0, "pretrain.student_forward": 10.0, "pretrain.backward": 50.0,
        "pretrain.update": 19.0, "rest": 0.0}
IDLE = {"pretrain.teacher": 0.0, "pretrain.student_forward": 0.0, "pretrain.backward": 46.0,
        "pretrain.update": 23.0, "rest": 9.0}


@pytest.fixture
def ctx(tmp_path, monkeypatch):
    monkeypatch.setattr(spans, "OUT", tmp_path)
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": EVENTS}))
    return SimpleNamespace(workload="cell", unit="step", units=1)


def test_split_by_launch_overlap_and_gap(ctx):
    got = spans.split(ctx)
    assert set(got) == set(BUSY)
    for name, (busy, idle) in got.items():
        assert busy == pytest.approx(BUSY[name] * 1e-3), name
        assert idle == pytest.approx(IDLE[name] * 1e-3), name


def test_split_sums_to_the_window_and_to_busy_s(ctx):
    got = spans.split(ctx)
    s = trace.summarize(EVENTS, window_s=197e-6)
    assert sum(b + i for b, i in got.values()) == pytest.approx(197e-3)  # [1, 198)
    assert sum(b for b, _ in got.values()) == pytest.approx(s.busy_s * 1e3)
    assert sum(i for _, i in got.values()) == pytest.approx(sum(s.idle_s.values()) * 1e3)


def test_phase_ms_is_busy_and_idle_a_unit(ctx):
    assert spans.phase_ms(ctx, "step", "pretrain.backward") == pytest.approx(0.096)
    assert spans.phase_ms(ctx, "step", "pretrain.teacher") == pytest.approx(0.040)


@pytest.mark.parametrize("units,unit,name", [
    (2, "step", "pretrain.backward"),     # two steps ran, the trace holds one step span
    (1, "step", "pretrain.ema"),          # no such span in the window
    (1, "step", "pretrain.hard_mask"),
    (1, "case", "predict.forward"),       # the reader of another unit
])
def test_nothing_on_a_unit_mismatch_or_a_missing_phase(ctx, units, unit, name):
    ctx.units = units
    assert spans.phase_ms(ctx, unit, name) is None


def test_nothing_without_spans_or_a_trace(ctx, tmp_path):
    ctx.workload = "no_trace"
    assert spans.split(ctx) is None
    bare = [e for e in EVENTS if not e["name"].startswith("pretrain.")]
    (tmp_path / "bare.trace.json").write_text(json.dumps({"traceEvents": bare}))
    ctx.workload = "bare"
    assert spans.split(ctx) is None
    assert spans.phase_ms(ctx, "step", "pretrain.backward") is None


def test_one_parse_for_each_version_of_the_file(ctx, tmp_path, monkeypatch):
    calls = []
    charge = spans.charge
    monkeypatch.setattr(spans, "charge", lambda events: calls.append(1) or charge(events))
    spans._cache.clear()
    for _ in range(3):
        spans.phase_ms(ctx, "step", "pretrain.update")
    assert len(calls) == 1
    (tmp_path / "cell.trace.json").write_text(json.dumps({"traceEvents": EVENTS[1:]}))
    assert spans.phase_ms(ctx, "step", "pretrain.update") is None  # no step span now
    assert len(calls) == 2

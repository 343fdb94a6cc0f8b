"""The port's phase spans (`anatomask_torch/utils/tracing.py`) on the CPU:
with the profiler off `span` is one shared null context; under
torch.profiler the AnatoMask and SparK steps and a Predictor case (device-
resident and streaming, two folds) open their spans once a unit, a
microbatch, a fold or a tile batch, in order and nested in the unit's; and
what the program returns is bitwise the same with the profiler on."""
import copy
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from anatomask_torch.inference import sliding_window as tsw
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.ssl import pretrain as tp
from anatomask_torch.utils import tracing

PKG = Path(tp.__file__).resolve().parent.parent
CFG = tp.PretrainConfig(encoder_dims=(4, 8, 16), encoder_depth=(1, 1, 1),
                        patch_size=(16, 16, 16), compute_dtype="float32")
STEP_TAIL = ["pretrain.update", "pretrain.ema"]
ANATOMASK_MICRO = ["pretrain.teacher", "pretrain.hard_mask", "pretrain.student_forward",
                   "pretrain.backward"]
TILE, VOLUME, FOLDS, TILE_BATCH = (16, 16, 16), (1, 24, 20, 16), 2, 2


def traced(fn):
    """fn() under torch.profiler (CPU): its result and the port's spans
    (start, end, name) in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in tracing.SPANS)
    return out, spans


def phases_of(spans, unit):
    """Each `unit` span's phases in order (back-to-back spans of one phase
    taken as one), after checking that each lies inside it."""
    out = []
    for s, e, _ in (x for x in spans if x[2] == unit):
        inside = [x for x in spans if s <= x[0] and x[1] <= e and x[2] != unit]
        out.append([k for k, _ in itertools.groupby(n for _, _, n in inside)])
    return out


def test_span_is_one_null_context_with_the_profiler_off(monkeypatch):
    def no_record_function(name):
        raise AssertionError(f"record_function({name!r}) with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", no_record_function)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("pretrain.step") is tracing.span("predict.case") is tracing._OFF
    with tracing.span("pretrain.step"), tracing.span("pretrain.teacher"):
        pass


def test_span_is_a_record_function_with_the_profiler_on():
    def opened():
        with tracing.span("pretrain.ema") as s:
            return s

    rf, spans = traced(opened)
    assert isinstance(rf, torch.profiler.record_function)
    assert [n for _, _, n in spans] == ["pretrain.ema"]


def test_the_sources_open_only_listed_spans_and_every_listed_one():
    used = set()
    for f in PKG.rglob("*.py"):
        used |= set(re.findall(r'\bspan\("([^"]+)"\)', f.read_text()))
    assert used == set(tracing.SPANS) and len(tracing.SPANS) == len(set(tracing.SPANS))


def _spark(seed=0):
    student = tp.build_spark_model(CFG, device="cpu", generator=torch.Generator().manual_seed(seed))
    return student, tp.make_teacher(student), tp.make_optimizer(student, CFG)


def _steps(objs, x, micro, anatomask=True, n=2):
    student, teacher, opt = objs
    gen = torch.Generator().manual_seed(5)
    if anatomask:
        return [tp.anatomask_train_step(student, teacher, opt, x, 3, gen, grad_accum_steps=micro)
                for _ in range(n)]
    return [tp.spark_train_step(student, opt, x, gen, grad_accum_steps=micro) for _ in range(n)]


@pytest.mark.parametrize("micro", [1, 2])
def test_anatomask_step_phases(micro):
    x = torch.randn(2, 1, *CFG.patch_size, generator=torch.Generator().manual_seed(3))
    _, spans = traced(lambda: _steps(_spark(), x, micro))
    want = ["pretrain.update"] + ANATOMASK_MICRO * micro + STEP_TAIL
    assert phases_of(spans, "pretrain.step") == [want, want]
    assert sum(n == "pretrain.step" for _, _, n in spans) == 2


@pytest.mark.parametrize("micro", [1, 2])
def test_anatomask_step_is_bitwise_the_same_traced(micro):
    x = torch.randn(2, 1, *CFG.patch_size, generator=torch.Generator().manual_seed(4))
    objs = _spark(1)
    copies = copy.deepcopy(objs)
    plain = _steps(objs, x, micro)
    on, _ = traced(lambda: _steps(copies, x, micro))
    for a, b in zip(plain, on):
        for u, v in zip(a, b):  # loss, hard mask, loss map
            assert torch.equal(u, v)
    for p, q in zip(objs[0].parameters(), copies[0].parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("micro", [1, 2])
def test_spark_step_phases(micro):
    x = torch.randn(2, 1, *CFG.patch_size, generator=torch.Generator().manual_seed(6))
    objs = _spark(2)
    copies = copy.deepcopy(objs)
    plain = _steps(objs, x, micro, anatomask=False)
    on, spans = traced(lambda: _steps(copies, x, micro, anatomask=False))
    want = (["pretrain.update"] + ["pretrain.student_forward", "pretrain.backward"] * micro
            + ["pretrain.update"])
    assert phases_of(spans, "pretrain.step") == [want, want]
    assert all(torch.equal(a, b) for a, b in zip(plain, on))


def _predictor():
    plans = {"dataset_name": "Dataset999_Tiny", "plans_name": "tinyPlans",
             "configurations": {"3d_fullres": {
                 "patch_size": list(TILE), "UNet_class_name": "STUNet-S",
                 "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
                 "conv_kernel_sizes": [[3, 3, 3]] * 3}}}
    pm = PlansManager(plans)
    cm = pm.get_configuration("3d_fullres")
    folds = [build_network_from_plans(pm, cm, 1, 3, deep_supervision=False, device="cpu",
                                      generator=torch.Generator().manual_seed(80 + f)
                                      ).state_dict() for f in range(FOLDS)]
    net = build_network_from_plans(pm, cm, 1, 3, deep_supervision=False, device="cpu")
    pred = Predictor(tile_batch_size=TILE_BATCH, device="cpu")
    pred.manual_initialization(net, pm, cm, folds, {"labels": {"background": 0, "a": 1, "b": 2},
                                                    "channel_names": {"0": "CT"}}, (0, 1, 2))
    return pred


@pytest.mark.parametrize("resident", [True, False])
def test_predictor_case_phases(resident, monkeypatch):
    monkeypatch.setattr(Predictor, "_fits_device_resident", staticmethod(lambda *a: resident))
    data = np.random.RandomState(9).rand(*VOLUME).astype(np.float32)
    pred = _predictor()
    plain = pred.predict_sliding_window_return_logits(data)
    on, spans = traced(lambda: pred.predict_sliding_window_return_logits(data))
    np.testing.assert_array_equal(on, plain)
    tiles = math.prod(len(s) for s in tsw.compute_steps_for_sliding_window(VOLUME[1:], TILE, 0.5))
    fold = (["predict.load_weights", "predict.upload"]
            + ["predict.tiles", "predict.forward", "predict.merge"] * -(-tiles // TILE_BATCH)
            + ["predict.download"])
    assert phases_of(spans, "predict.case") == [fold * FOLDS]

"""A run with the timed path broken underneath comes out not correct, under
the cell's own limits: a step that leaves its state unchanged, a step whose
loss leaves out half of the batch, a prediction whose answer is altered
where it is produced, a prediction that leaves out half of its mirrored
copies. The sound run beside them is correct. (The cells run on one chip:
no exchange between chips to leave out.)"""
import numpy as np
import pytest

import anatomask_torch.inference.predictor as predictor
import anatomask_torch.ssl.pretrain as pretrain
from benchmark.conftest import run_tiny, tiny_spec


def unchanged(monkeypatch):
    monkeypatch.setattr(pretrain, "_update", lambda student, opt, micro, lr, clip, loss: loss)
    monkeypatch.setattr(pretrain, "ema_update", lambda teacher, student, decay: None)


def half_batch(monkeypatch):
    full = pretrain.spark_loss

    def loss(inp, rec, active):
        value, loss_map = full(inp, rec, active)
        h = max(1, loss_map.shape[0] // 2)
        masked = 1.0 - active.reshape(active.shape[0], -1).float()
        return loss_map[:h].sum() / masked[:h].sum(), loss_map
    monkeypatch.setattr(pretrain, "spark_loss", loss)


def altered(monkeypatch):
    full = predictor.sliding_window_predict_device_resident

    def predict(*args, **kw):
        out = full(*args, **kw)
        out[:, :8, :8, :8] += np.abs(out).max()
        return out
    monkeypatch.setattr(predictor, "sliding_window_predict_device_resident", predict)


def half_flips(monkeypatch):
    full = predictor.make_tile_predictor
    monkeypatch.setattr(predictor, "make_tile_predictor",
                        lambda apply_fn, axes=None: full(apply_fn, tuple(axes or ())[:-1]))


@pytest.mark.parametrize("workload", ["pretrain-B.anatomask", "predict-B.volume"])
def test_sound_run_is_correct(workload):
    assert run_tiny(tiny_spec(workload))["correct"]


@pytest.mark.parametrize("workload,fault", [("pretrain-B.anatomask", unchanged),
                                            ("pretrain-B.anatomask", half_batch),
                                            ("predict-B.volume", altered),
                                            ("predict-B.volume", half_flips)])
def test_fault_is_not_correct(monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run_tiny(tiny_spec(workload))
    assert not res["correct"], res["checks"]

"""The plain reference against the port's CPU path at a tiny width, both in
float32: every compared number at round-off."""
import pytest

from benchmark.conftest import run_tiny, tiny_spec

# float32 on both sides; Adam's first updates are the gradients' signs, so
# the few elements whose gradient is near 0 may differ in the change
ROUND_OFF = {"loss_rel": 1e-5, "loss_map_rel": 1e-5, "forced_gap": 1e-5,
             "hard_mask_wrong": 0.0, "grad_median_gap": 1e-3, "update_leaf_gap": 0.05,
             "ema_leaf_gap": 0.05, "logits_rel_max": 1e-5}


@pytest.mark.parametrize("workload", ["pretrain-B.anatomask", "predict-B.volume"])
def test_reference_agrees_with_the_port_in_float32(workload):
    res = run_tiny(tiny_spec(workload, "float32"))
    assert res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] <= ROUND_OFF[name], (name, c)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1

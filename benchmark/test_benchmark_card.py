"""On the card only: one short run of each one-chip cell through the
command BENCHMARK.json gives, correct, with a result line of the contract's
keys. Skips without a CUDA device."""
import json
import subprocess

import pytest
import torch

from benchmark import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
         if w["chips"] == 1]


@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = harness.load_json(harness.ROOT / "BENCHMARK.json")["command"]
    out = subprocess.run(cmd + ["--workload", workload, "--seed", str(2 ** 31 + 99),
                                "--seconds", "3", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["correct"] and result["device"]["platform"] == "gpu"

"""The control, the reference in the program's place with float8 convs
(the precision below the configuration's bfloat16), comes out not correct
under the cell's limits. On the card it is read at the cells' own sizes by
`python3 -m benchmark.calibrate --side control`."""
import pytest
import torch

from benchmark import harness
from benchmark.conftest import tiny_spec
from benchmark.reference import stunet as reference


@pytest.mark.parametrize("workload", ["pretrain-B.anatomask", "predict-B.volume"])
def test_float8_control_is_not_correct(workload):
    spec = tiny_spec(workload, "bfloat16")
    cell = spec.driver().Cell(spec.config, spec.traffic, 2 ** 31 + 23, torch.device("cpu"))
    cell.stand_in(reference.FP8)
    correct, checks = harness.judge(cell.check(), spec.limits)
    assert not correct, checks


def test_exact_stand_in_reads_zero():
    spec = tiny_spec("pretrain-B.anatomask", "float32")
    cell = spec.driver().Cell(spec.config, spec.traffic, 5, torch.device("cpu"))
    cell.stand_in(reference.EXACT)
    assert all(v == 0.0 for v in cell.check().values())

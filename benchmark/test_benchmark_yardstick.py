"""The yardstick's counts against the configurations' published sizes."""
import json
import math

import pytest

from benchmark import harness
from benchmark.reference import stunet as reference
from benchmark.yardstick import stunet as yardstick

H100 = dict(peak_flops=989e12, peak_bytes=3.35e12, itemsize=2)


def config(name):
    return harness.load_json(harness.ROOT / "benchmark" / "configs" / f"{name}.json")


def test_stunet_b_step_flops_match_the_macs_of_probes_flops_baseline():
    cfg = config("stunet-b")
    convs = yardstick.spark_convs(cfg)
    fwd_mac = sum(c.flops() for c in convs) / 2
    # probes/flops_baseline.py counts the finest densify layer too, which the
    # port does not compute: 32 -> 32 channels, 3x3x3, at 112x112x128
    unread = 112 * 112 * 128 * 32 * 32 * 27
    assert round((fwd_mac + unread) / 1e9, 1) == 790.4
    assert round(4 * 4 * (fwd_mac + unread) * 2 / 1e12, 2) == 25.29
    step = yardstick.pretrain_step(cfg, 4, **H100)
    assert step.flops == pytest.approx(4 * 4 * 2 * fwd_mac)
    assert round(step.flops / 1e12, 2) == 23.87


def test_launches_and_bounds_of_the_cells():
    b, h = config("stunet-b"), config("stunet-h")
    step = yardstick.pretrain_step(b, 4, **H100)
    # 17 stride-1 3x3x3 convs a forward: two forwards, dx at all but the stem
    assert step.conv_launches == 2 * 17 + 16
    assert step.conv_bound_s * 1e3 == pytest.approx(15.40, abs=0.01)
    h_step = yardstick.pretrain_step(h, 4, **H100)
    # 34 sites under remat (3 forwards), 3 densify sites (2), in 2 microbatches
    assert h_step.conv_launches == 2 * (34 * 3 + 33 + 3 * 3)
    assert round(h_step.flops / 1e12, 1) == 313.6
    tiles = yardstick.tile_count((240, 240, 155), (128, 128, 128), 0.5)
    assert tiles == 18
    case = yardstick.predict_case(b, tiles, 8, 1, **H100)
    assert case.conv_launches == 18 * 17
    assert case.conv_bound_s * 1e3 == pytest.approx(136.94, abs=0.01)


@pytest.mark.parametrize("name,table,key", [("stunet-b", "spark", "pretrain"),
                                            ("stunet-b", "segnet", "segmentation"),
                                            ("stunet-h", "spark", "pretrain")])
def test_parameter_counts_are_the_published_ones(name, table, key):
    cfg = config(name)
    params = getattr(reference, f"{table}_params")(cfg)
    assert sum(math.prod(s) for _, s, _ in params) == cfg[key]["parameters"]


def test_reference_tile_origins_cover_the_volume():
    origins = reference.tile_origins((240, 240, 155), (128, 128, 128), 0.5)
    assert len(origins) == yardstick.tile_count((240, 240, 155), (128, 128, 128), 0.5)
    assert {o[2] for o in origins} == {0, 27}
    assert json.dumps(sorted({o[0] for o in origins})) == "[0, 56, 112]"

"""BENCHMARK.json against the benchmark's contract: names and units, the
keys of each entry, the files each entry names, every per-layer metric's
`moves` reported in each of its cells, the bounds, and the run length that
fits a full check of 24 cells."""
import json
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and M["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])
    assert len(json.dumps(M)) <= 64 * 1024


def test_names_units_and_text_fields():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in M[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in M[k]}) == len(M[k])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in M["configs"] + M["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in M["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_config_is_used_and_every_pair_once():
    assert {w["config"] for w in M["workloads"]} == {c["name"] for c in M["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_each_cell_has_its_files_and_metrics(workload):
    spec = harness.load_spec(workload)
    assert (ROOT / "benchmark" / "drivers" / f"{spec.traffic['driver']}.py").is_file()
    assert spec.limits, "no limits file"
    e2e = {m["name"] for m in spec.end_to_end()}
    assert "setup_s" in e2e and len(e2e - {"setup_s"}) >= 1
    layer = spec.per_layer()
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert "workloads" not in target or w in target["workloads"]
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers <= {"Step", "Predictor", "Kernels", "Library ops", "Device"}


def test_bounds_and_run_length():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in M["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25
    r = M["run_seconds"]
    assert 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200

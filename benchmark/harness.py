"""One run of one cell, driven by data: `BENCHMARK.json` names the cell, its
configuration file and its traffic mix; the traffic file names its driver
(`drivers/<driver>.py`); the cell's limits are `limits/<cell>.json`; each
per-layer metric is read by `metrics/<metric>.py`. A new cell, configuration
or per-layer metric is new files and entries, not an edit here. A limits
file gives each compared number its `limit` beside the readings it was set
from: `lower` (the most that sound runs of the program read) and `upper`
(the least that the control or a fault reads).

The run: set-up (the driver builds the program, loads the benchmark's
weights, warms up every shape the cell uses), then the window (whole units
of work back to back for the given seconds; with `trace` a shorter window
under the profiler), the peak memory read, the program's state freed, and
the check against the plain reference, whose numbers decide `correct`.
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import trace as tracing

ROOT = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, found by name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, workload: str, reported: Optional[set] = None) -> bool:
    """A metric is reported in a cell that its `workloads` list, or, without
    the list, in every cell (per-layer: every cell that reports the
    end-to-end metric it `moves`)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


@dataclass
class Spec:
    """A cell as the files describe it."""
    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, Optional[float]] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"] if applies(m, self.name)]

    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"] if applies(m, self.name, reported)]

    def driver(self):
        d = self.traffic["driver"]
        return load_module(self.root / "benchmark" / "drivers" / f"{d}.py", f"_driver_{d}")


def load_spec(workload: str, root: Path = ROOT) -> Spec:
    manifest = load_json(root / "BENCHMARK.json")
    wl = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in {root / 'BENCHMARK.json'}")
    entry = next(c for c in manifest["configs"] if c["name"] == wl["config"])
    config = load_json(root / entry["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{wl['traffic']}.json")
    limits_path = root / "benchmark" / "limits" / f"{workload}.json"
    limits = ({k: v["limit"] for k, v in load_json(limits_path).items()}
              if limits_path.is_file() else {})
    return Spec(root, manifest, wl, config, traffic, limits)


def peaks(root: Path, kind: str) -> dict:
    """The published peaks of the device `kind` (peaks.json, by a part of
    its name; the H100 SXM's where none matches)."""
    table = load_json(root / "benchmark" / "peaks.json")
    return next((p for p in table["devices"] if p["match"] in kind), table["devices"][0])


@dataclass
class Context:
    """What a per-layer metric's reader may read of a traced run."""
    workload: str
    unit: str                      # "step" or "case"
    units: int                     # units of work in the traced window
    trace: tracing.TraceSummary
    work: object                   # the yardstick's Work of one unit
    peak: dict                     # the device's published peaks
    conv_launches: Optional[int]   # the port's count of kernel #1 and #2 launches in the window

    def group_ms_per_unit(self, group: str) -> float:
        return self.trace.group_s.get(group, 0.0) * 1e3 / self.units


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device: torch.device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]):
    """(correct, checks): each number beside its limit (None: not compared);
    correct when every compared number is finite and within its limit and
    there is at least one."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    compared = [c for c in checks.values() if c["limit"] is not None]
    ok = bool(compared) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in compared)
    return ok, checks


def run(spec: Spec, seed: int, seconds: float, trace: bool, device, process_start: float,
        log=print) -> dict:
    """One run of the cell; returns its result line's object (with `checks`
    last)."""
    device = torch.device(device)
    cell = spec.driver().Cell(spec.config, spec.traffic, seed, device)
    cell.setup()
    _synchronize(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result: dict = {}
    if trace:
        before = cell.counters()
        path = spec.root / "benchmark" / "out" / f"{spec.name}.trace.json"
        units, summary = tracing.profile(
            lambda: cell.run(spec.traffic["trace_seconds"], spec.traffic["trace_min_units"]),
            str(path), lambda: _synchronize(device))
        after = cell.counters()
        info = device_info(device, spec.workload["chips"])
        peak = peaks(spec.root, info["kind"])
        work = cell.work(peak)
        counted = after["conv"] - before["conv"] if "conv" in after and "conv" in before else None
        log(f"kernels #1 and #2: {counted} launches counted by the program, "
            f"{work.conv_launches * units} predicted from the shapes")
        ctx = Context(spec.name, cell.unit, units, summary, work, peak, counted)
        metrics = {}
        for m in spec.per_layer():
            value = load_module(spec.root / "benchmark" / "metrics" / f"{m['name']}.py",
                                f"_metric_{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"], info["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = summary.breakdown()
        window_s = summary.window_s
    else:
        t0 = time.time()
        setup_s = t0 - process_start
        w0 = time.perf_counter()
        units = cell.run(seconds)
        window_s = time.perf_counter() - w0
        info = device_info(device, spec.workload["chips"])
        values = {cell.end_to_end: cell.end_to_end_value(units, window_s),
                  "peak_mem_gib": info["memory_peak_bytes"] / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec.end_to_end() if m["name"] in values}
    failed = cell.failed()
    log(f"window: {units} {cell.unit}s in {window_s:.3f} s; peak memory "
        f"{info['memory_peak_bytes']} bytes")
    cell.release()
    t_check = time.perf_counter()
    numbers = cell.check()
    log(f"check: {time.perf_counter() - t_check:.1f} s")
    correct, checks = judge(numbers, spec.limits)
    result = {"correct": correct and failed == 0, "attempted": units, "failed": failed,
              "metrics": metrics, "device": info, **result, "checks": checks}
    return result

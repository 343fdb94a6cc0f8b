"""The traced window split by the program's phase spans.

The port opens `record_function` spans named `pretrain.*` and `predict.*`
(`anatomask_torch/utils/tracing.py`) while the profiler runs; they land in
the traced run's own Chrome trace, `out/<cell>.trace.json`, on the clock of
the kernels. Each device operation (kernel, copy, memset) goes to the
innermost such span, on any host thread, whose interval holds the runtime
call that launched it (matched by `args.correlation`): the autograd engine
launches the backward's kernels from its own thread while the main thread
waits inside `pretrain.backward`. An operation counts its part of the
device's union, an overlap going once, to the operation that started first,
so that the phases' busy time sums to the trace's `busy_s`. Each idle gap
between the merged device intervals, and the window's two ends as
`trace.summarize` takes them, goes to the innermost span open at its
midpoint, short gaps too.

A phase reads (busy + idle charged to it) in ms a unit. Nothing where the
trace holds another number of unit spans (`pretrain.step`, `predict.case`)
than the window ran units, where the phase has no span in the window (the
program opens none: a parent commit, the SparK step's missing teacher), or
where no device operation ran.
"""
from __future__ import annotations

import bisect
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from benchmark import trace as tracing

OUT = Path(__file__).resolve().parent / "out"
PREFIXES = ("pretrain.", "predict.")
UNIT_SPANS = {"step": "pretrain.step", "case": "predict.case"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REST = "rest"


@dataclass
class Charges:
    """A trace's device time (busy) and idle time by the span charged, in
    us; "" where no span was open. `counts`: the spans of each name."""
    busy_us: Dict[str, float]
    idle_us: Dict[str, float]
    counts: Dict[str, int]
    n_device_ops: int


class _Innermost:
    """The innermost program span open at a moment: the shortest of those
    whose [start, end) holds it, looked up by elementary interval."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.points = sorted({p for s, e, _ in spans for p in (s, e)})
        self.names = []
        for a, b in zip(self.points, self.points[1:]):
            m = 0.5 * (a + b)
            inner = min(((e - s, n) for s, e, n in spans if s <= m < e), default=(0.0, ""))
            self.names.append(inner[1])

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.points, t) - 1
        return self.names[i] if 0 <= i < len(self.names) else ""


def charge(events: List[dict]) -> Charges:
    """Busy and idle time of a Chrome trace's events by program span."""
    spans, launches, device, host = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, s, d = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
        if cat == "user_annotation" and e["name"].startswith(PREFIXES):
            spans.append((s, s + d, e["name"]))
        elif cat in tracing.DEVICE_CATS:
            device.append((s, s + d, e.get("args", {}).get("correlation")))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = s
        if cat in tracing.HOST_CATS:
            host.append((s, s + d))
    inner = _Innermost(spans)
    busy: Dict[str, float] = {}
    idle: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for _, _, n in spans:
        counts[n] = counts.get(n, 0) + 1
    covered = float("-inf")
    for s, e, corr in sorted(device, key=lambda x: x[:2]):
        part = e - max(s, covered)
        covered = max(covered, e)
        if part > 0:
            t = launches.get(corr)
            name = "" if t is None else inner.at(t)
            busy[name] = busy.get(name, 0.0) + part
    _, merged = tracing.union_us([(s, e) for s, e, _ in device])
    gaps = list(zip([e for _, e in merged], [s for s, _ in merged[1:]]))
    if merged and host:
        first, last = min(h[0] for h in host), max(h[1] for h in host)
        gaps += [(first, merged[0][0]), (merged[-1][1], last)]
    for a, b in gaps:
        if b > a:
            name = inner.at(0.5 * (a + b))
            idle[name] = idle.get(name, 0.0) + (b - a)
    return Charges(busy, idle, counts, len(device))


_cache: Dict[str, Tuple[Tuple[int, int], Charges]] = {}


def charges(path: Path) -> Optional[Charges]:
    """`charge` of the trace at `path`, parsed once for each version of the
    file; nothing where there is no file."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    key, stamp = str(path), (st.st_mtime_ns, st.st_size)
    if key not in _cache or _cache[key][0] != stamp:
        with open(path) as f:
            _cache[key] = (stamp, charge(json.load(f)["traceEvents"]))
    return _cache[key][1]


def _window(ctx) -> Optional[Charges]:
    """The charges of `ctx`'s traced window, where its unit spans match its
    units and a device operation ran."""
    unit_span = UNIT_SPANS.get(ctx.unit)
    c = charges(OUT / f"{ctx.workload}.trace.json")
    if (unit_span is None or c is None or not c.n_device_ops
            or c.counts.get(unit_span, 0) != ctx.units):
        return None
    return c


def phase_ms(ctx, unit: str, name: str) -> Optional[float]:
    """The ms a unit charged to span `name` (busy + idle), in a cell whose
    unit is `unit`; nothing where the window has no such span."""
    c = _window(ctx) if ctx.unit == unit else None
    if c is None or not c.counts.get(name):
        return None
    return (c.busy_us.get(name, 0.0) + c.idle_us.get(name, 0.0)) * 1e-3 / ctx.units


def split(ctx) -> Optional[Dict[str, Tuple[float, float]]]:
    """Every phase of the cell's unit with a span in the window, and `rest`
    (the unit span outside its phases, other spans, no span): (busy ms, idle
    ms) a unit. The phases and `rest` sum to the window's ms a unit, their
    busy parts to the trace's busy time."""
    c = _window(ctx)
    if c is None:
        return None
    unit_span = UNIT_SPANS[ctx.unit]
    prefix = unit_span.split(".")[0] + "."
    phases = {n for n in c.counts if n.startswith(prefix) and n != unit_span}
    out = {n: (0.0, 0.0) for n in sorted(phases) + [REST]}
    for n in set(c.busy_us) | set(c.idle_us):
        k = n if n in phases else REST
        b, i = out[k]
        out[k] = (b + c.busy_us.get(n, 0.0) * 1e-3 / ctx.units,
                  i + c.idle_us.get(n, 0.0) * 1e-3 / ctx.units)
    return out

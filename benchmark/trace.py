"""The traced window: torch.profiler over whole units of work, its Chrome
trace read back into device intervals by kernel group, the device's busy
time as the union of its operations, and the idle gaps labelled with what
the host was doing.

Only kernels, copies and memsets count as device work. The profiler's GPU
user annotations (`Optimizer.step#AdamW.step` and the like) span other
work and are left out, and overlapping operations count once.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# gaps shorter than this are summed under one label, not looked up
SHORT_GAP_US = 10.0

# (group, substrings of the kernel's demangled name); the first match wins
KERNEL_GROUPS = (
    ("conv", ("conv3x3_wgmma", "conv3x3_tf32x3", "conv3x3_kernel", "stem_kernel",
              "stem_fp32_kernel")),
    ("moments", ("moments_kernel",)),
    ("elementwise", ("at::native", "at::cuda", "c10::")),
    ("library", ("cudnn", "xmma", "cutlass", "nvjet", "gemm", "gemv", "conv", "dgrad", "wgrad",
                 "fprop", "implicit", "nchwToNhwc", "nhwcToNchw", "splitK", "cublas", "sm90_",
                 "sm80_")),
)


def kernel_group(name: str, cat: str = "kernel") -> str:
    """The group of a device operation: `conv` (the port's stride-1 3x3x3
    kernels #1 and #2, every variant), `moments` (kernel #3), `elementwise`
    (PyTorch's own kernels: elementwise, copies, reductions, the
    optimizer's), `library` (cuDNN, cuBLAS, CUTLASS), `memcpy`, `memset`,
    `other`."""
    if cat == "gpu_memcpy":
        return "memcpy"
    if cat == "gpu_memset":
        return "memset"
    return next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its return type, arguments and the inner
    template arguments beyond `limit` characters."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:  # cut at the argument list, outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    return "".join(out)[:limit]


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length, merged intervals) of [start, end) intervals."""
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return sum(e - s for s, e in merged), merged


@dataclass
class TraceSummary:
    """What a traced window holds: device seconds by group and by kernel,
    the busy seconds (the union of device operations), the window's wall
    seconds by the host's clock, and idle seconds by host label."""
    window_s: float
    busy_s: float
    group_s: Dict[str, float] = field(default_factory=dict)
    kernel_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    n_device_ops: int = 0

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


class _HostIndex:
    """Host events sorted by start, to find those that cover a moment."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e[0])
        self.starts = [e[0] for e in self.events]

    def label(self, t: float, lookback: int = 400) -> str:
        i = bisect.bisect_right(self.starts, t)
        outer, inner = None, None
        for s, e, name, cat in self.events[max(0, i - lookback):i][::-1]:
            if e < t:
                continue
            if cat == "cpu_op" and (outer is None or e - s > outer[1] - outer[0]):
                outer = (s, e, name)
            if cat != "cpu_op" and (inner is None or e - s < inner[1] - inner[0]):
                inner = (s, e, name)
        parts = [x[2] for x in (outer, inner) if x is not None]
        return " / ".join(parts) if parts else "host between ops"


def summarize(events: List[dict], window_s: float) -> TraceSummary:
    """Read a Chrome trace's events (as torch.profiler exports them)."""
    device, host = [], []
    group_s: Dict[str, float] = {}
    kernel_s: Dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((s, s + d))
            g = kernel_group(e["name"], cat)
            group_s[g] = group_s.get(g, 0.0) + d * 1e-6
            k = short_name(e["name"]) if cat == "kernel" else cat
            kernel_s[k] = kernel_s.get(k, 0.0) + d * 1e-6
        elif cat in HOST_CATS:
            host.append((s, s + d, e["name"], cat))
    busy_us, merged = union_us(device)
    idle: Dict[str, float] = {}
    index = _HostIndex(host)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        gap = b - a
        label = (f"gaps under {SHORT_GAP_US:g} us" if gap < SHORT_GAP_US
                 else index.label(0.5 * (a + b)))
        idle[label] = idle.get(label, 0.0) + gap * 1e-6
    # the window's ends: from its first host event to its first device
    # operation, and from its last device operation to its last host event
    if merged and host:
        first = min(h[0] for h in host)
        last = max(h[1] for h in host)
        for a, b in ((first, merged[0][0]), (merged[-1][1], last)):
            if b > a:
                label = index.label(0.5 * (a + b))
                idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return TraceSummary(window_s=window_s, busy_s=busy_us * 1e-6, group_s=group_s,
                        kernel_s=kernel_s, idle_s=idle, n_device_ops=len(device))


def profile(run: Callable[[], int], trace_path: str, synchronize: Callable[[], None]
            ) -> Tuple[int, TraceSummary]:
    """`run()` (which returns its units of work and ends with the device
    idle) under torch.profiler with CPU and CUDA activities; the window is
    timed by the host's clock from a synchronize to the end of `run`. The
    Chrome trace is written to `trace_path` and read back."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synchronize()
        t0 = time.perf_counter()
        units = run()
        window_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return units, summarize(events, window_s)


"""Device time of the kernels whose full demangled name holds a word, read
from a traced run's Chrome trace (`out/<cell>.trace.json`, as `spans.py`
reads it). `trace.TraceSummary.kernel_s` keys kernels by `trace.short_name`,
which cuts a name at its first parenthesis: `at::native::(anonymous
namespace)::conv_depthwise3d_cuda_kernel<...>` becomes `at::native::` there,
merged with PyTorch's other kernels. Here the whole name is matched."""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

from benchmark import spans

_cache: Dict[str, Tuple[Tuple[int, int], Dict[str, float]]] = {}


def _kernel_us(path: Path) -> Optional[Dict[str, float]]:
    """Device us by full kernel name, parsed once for each version of the
    file; nothing where there is no file."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return None
    key, stamp = str(path), (st.st_mtime_ns, st.st_size)
    if key not in _cache or _cache[key][0] != stamp:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        us: Dict[str, float] = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                us[e["name"]] = us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
        _cache[key] = (stamp, us)
    return _cache[key][1]


def device_s(workload: str, word: str) -> Optional[float]:
    """Seconds of the traced window's kernels whose name holds `word`;
    nothing where the cell has no trace or no such kernel ran."""
    us = _kernel_us(spans.OUT / f"{workload}.trace.json")
    if us is None:
        return None
    total = sum(v for k, v in us.items() if word in k)
    return total * 1e-6 if total > 0 else None

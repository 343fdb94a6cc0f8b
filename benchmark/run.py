"""Run one cell of the benchmark once, on the card of this machine:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result's JSON object; the last lines of standard error are the compared
numbers, each beside its limit. Exits non-zero, and prints no result,
without a CUDA device (or fewer than the cell asks for), when the program's
package is not the checkout's own, or when a JAX module was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "anatomask_tpu")


def process_start() -> float:
    """The epoch seconds at which this process started (the clock ticks
    /proc/self/stat counts from boot), or now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def err(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness
    # caches of the program, should it use them, at fixed places in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(harness.ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(harness.ROOT / "build" / "torch_extensions"))
    spec = harness.load_spec(args.workload)

    import torch
    chips = spec.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"{args.workload} needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    try:
        import anatomask_torch
    except ImportError as e:
        err(f"the program is not in this checkout: {e}")
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(anatomask_torch.__file__))) != str(
            harness.ROOT):
        err(f"anatomask_torch comes from {anatomask_torch.__file__}, not from {harness.ROOT}")
        return 2

    result = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", started,
                         log=err)
    bad = forbidden_modules()
    if bad:
        err(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        err(f"{name} {c['value']!r} {limit}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

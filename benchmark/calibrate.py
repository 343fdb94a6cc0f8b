"""The readings the correctness limits are set from, on the card, at a
cell's own sizes, several seeds in one process (the benchmark's runs do not
run this):

    python3 -m benchmark.calibrate --workload <name> --side <side> --seeds <n> ... [--out FILE]

Sides: `program` (the program's set-up and a short window, as a run makes
them), `control` (the reference in the program's place with float8
convolutions, the precision below the configuration's bfloat16) and
`half_batch` (the reference in the program's place with the student's loss
over half of each batch). Each seed prints one JSON line of the compared
numbers, appended to FILE where given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness
from benchmark.reference import stunet as reference


def reading(spec: harness.Spec, seed: int, side: str, device: str) -> dict:
    cell = spec.driver().Cell(spec.config, spec.traffic, seed, torch.device(device))
    t0 = time.perf_counter()
    if side == "program":
        cell.setup()
        cell.run(0.0, spec.traffic.get("checked_cases", 2) if cell.unit == "case" else 0)
        cell.release()
    elif side == "control":
        cell.stand_in(reference.FP8)
    elif side == "half_batch":
        cell.stand_in(batch_fraction=0.5)
    else:
        raise ValueError(f"unknown side {side!r}")
    numbers = cell.check()
    return {"workload": spec.name, "side": side, "seed": seed, "numbers": numbers,
            "seconds": time.perf_counter() - t0, "worst_leaves": getattr(cell, "detail", None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", required=True, choices=("program", "control", "half_batch"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec(args.workload)
    for seed in args.seeds:
        line = json.dumps(reading(spec, seed, args.side, "cuda:0"))
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batch-run command generation + cross-dataset result collection.

After nnU-Net's nnunetv2/batch_running/ — the reference
generates LSF cluster command lines for Decathlon-style sweeps
(generate_lsf_runs_customDecathlon.py), collects per-fold validation Dice
across datasets/trainers/configs into CSVs
(collect_results_custom_Decathlon.py) and summarizes benchmark trainer
results (summarize_benchmark_results.py). Here the generator emits plain shell
command lists (one per line) that can be fed to any scheduler (GKE/XManager/
slurm/bash); `collect_results`/`summarize_collected_results` walk this
framework's results tree (<results>/<Dataset>/<trainer>__<plans>__<config>/
fold_<f>/validation/summary.json); the benchmark summarizer reads the
benchmark_result.json files written by the benchmark trainers.

Counterpart of anatomask_tpu/utils/batch_running.py, copied function for
function, with one departure: the command lines run the port's own entry,
`atk_torch_train`, where JAX's run `atk_train`.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import load_json


def generate_training_commands(
    datasets: Sequence,
    configurations: Sequence[str] = ("3d_fullres",),
    trainers: Sequence[str] = ("ATKTrainer",),
    plans: Sequence[str] = ("ATKPlans",),
    folds: Sequence[int] = (0, 1, 2, 3, 4),
    extra_args: str = "",
) -> List[str]:
    cmds = []
    for d in datasets:
        for tr in trainers:
            for p in plans:
                for c in configurations:
                    for f in folds:
                        cmd = f"atk_torch_train {d} {c} {f} -tr {tr} -p {p}"
                        if extra_args:
                            cmd += f" {extra_args}"
                        cmds.append(cmd)
    return cmds


def wrap_commands_for_scheduler(
    cmds: Sequence[str],
    scheduler: str = "lsf",
    scheduler_args: str = "",
    preamble: str = "",
) -> List[str]:
    """Wrap plain `atk_torch_train ...` command lines in cluster-scheduler
    submissions, matching the reference's LSF emission shape
    (nnU-Net's nnunetv2/batch_running/generate_lsf_runs_customDecathlon.py:82-85:
    `bsub <resources/queue/gpu args> -L /bin/bash "source <env> && <cmd>"`).

    scheduler: "lsf" -> bsub lines, "slurm" -> sbatch --wrap lines,
    "none" -> the commands unchanged (the scheduler-agnostic default the
    generators emit). scheduler_args: resource/queue flags pasted verbatim
    after the scheduler binary (the reference hardcodes DKFZ host excludes +
    `-q gpu-lowprio -gpu num=1:...`; other clusters name accelerators in their own
    flags, so this stays caller-supplied). preamble: environment-setup shell
    (e.g. "source ~/env.sh && ") prefixed inside the submitted command.
    """
    if scheduler in ("none", ""):
        return list(cmds)
    import shlex
    sa = f" {scheduler_args}" if scheduler_args else ""
    # shlex.quote the submitted command: embedded quotes in
    # preamble/extra_args must not break the bsub/sbatch line
    if scheduler == "lsf":
        return [f"bsub{sa} -L /bin/bash {shlex.quote(preamble + c)}" for c in cmds]
    if scheduler == "slurm":
        return [f"sbatch{sa} --wrap {shlex.quote(preamble + c)}" for c in cmds]
    raise ValueError(f"unknown scheduler {scheduler!r} (lsf|slurm|none)")


def generate_benchmark_commands(datasets: Sequence, configurations=("2d", "3d_fullres")) -> List[str]:
    cmds = []
    for tr in ("ATKTrainerBenchmark_5epochs", "ATKTrainerBenchmark_5epochs_noDataLoading"):
        cmds.extend(generate_training_commands(datasets, configurations, trainers=(tr,), folds=(0,)))
    return cmds


def collect_results(trainers: Dict[str, Sequence[str]], datasets: Sequence,
                    output_file: str,
                    configurations: Sequence[str] = ("2d", "3d_fullres",
                                                     "3d_lowres",
                                                     "3d_cascade_fullres"),
                    folds: Sequence[int] = (0, 1, 2, 3, 4)) -> None:
    """Walk the results tree and write one CSV row per existing
    (dataset, config, trainer, plans) with the per-fold validation
    foreground-mean Dice and their nanmean, matching the reference collector
    (nnU-Net's nnunetv2/batch_running/collect_results_custom_Decathlon.py:12-40).
    Missing folds are left as empty cells (NaN in the mean)."""
    import numpy as np
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    results_root = require("results")
    with open(output_file, "w") as f:
        for d in datasets:
            name = maybe_convert_to_dataset_name(d)
            for c in configurations:
                for trainer, plans_list in trainers.items():
                    for plans in plans_list:
                        model_dir = os.path.join(
                            results_root, name, f"{trainer}__{plans}__{c}")
                        if not os.path.isdir(model_dir):
                            continue
                        f.write(f"{name},{c},{trainer},{plans},{results_root}")
                        fold_dices = []
                        for fl in folds:
                            sf = os.path.join(model_dir, f"fold_{fl}",
                                              "validation", "summary.json")
                            if not os.path.isfile(sf):
                                print("expected output file not found:", sf)
                                f.write(",")
                                fold_dices.append(np.nan)
                            else:
                                dice = load_json(sf)["foreground_mean"]["Dice"]
                                fold_dices.append(dice)
                                f.write(",%02.4f" % dice)
                        f.write(",%02.4f\n" % np.nanmean(fold_dices))


def summarize_collected_results(input_file: str, output_file: str,
                                folds: Sequence[int], configs: Sequence[str],
                                datasets: Sequence,
                                trainers: Dict[str, Sequence[str]]) -> None:
    """Pivot a collect_results CSV into one row per trainer__plans with a
    column per (dataset_id, config) mean-over-folds Dice and a trailing
    overall mean (reference summarize, collect_results_custom_Decathlon.py:43-92).
    Rows with any missing fold yield 'nan' for that cell."""
    import numpy as np
    from anatomask_torch.utils.helpers import (convert_dataset_name_to_id,
                                             maybe_convert_to_dataset_name)
    rows = [ln.rstrip("\n").split(",") for ln in open(input_file)
            if ln.strip()]
    valid_configs = {}
    for d in datasets:
        name = maybe_convert_to_dataset_name(d)
        present = sorted({r[1] for r in rows if r[0] == name})
        valid_configs[name] = [c for c in present if c in configs]
    with open(output_file, "w") as f:
        f.write("name")
        for name, cs in valid_configs.items():
            for c in cs:
                f.write(",%d_%s" % (convert_dataset_name_to_id(name), c[:4]))
        f.write(",mean\n")
        for trainer, plans_list in trainers.items():
            for plans in plans_list:
                f.write(f"{trainer}__{plans}")
                r = []
                for name, cs in valid_configs.items():
                    for c in cs:
                        sel = [row for row in rows
                               if row[:4] == [name, c, trainer, plans]]
                        assert len(sel) <= 1, "duplicate collect_results row"
                        # row = 4 keys + results_root + per-fold cells + mean
                        num_folds = len(sel[0]) - 6 if sel else 0
                        cells = ([sel[0][5 + i] for i in folds]
                                 if sel and max(folds) < num_folds else [])
                        if not cells or "" in cells:
                            print("missing:", trainer, plans, name, c)
                            f.write(",nan")
                            r.append(np.nan)
                        else:
                            m = float(np.mean([float(v) for v in cells]))
                            f.write(",%02.4f" % m)
                            r.append(m)
                f.write(",%02.4f\n" % np.mean(r))


def summarize_benchmark_results(datasets: Sequence, output_file: Optional[str] = None) -> Dict:
    """Collect benchmark_result.json files across datasets/trainers into one
    table keyed by (dataset, trainer, configuration, hardware)."""
    from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name
    results_root = require("results")
    table: Dict[str, dict] = {}
    for d in datasets:
        name = maybe_convert_to_dataset_name(d)
        base = os.path.join(results_root, name)
        if not os.path.isdir(base):
            continue
        for model_dir in sorted(os.listdir(base)):
            if "Benchmark" not in model_dir:
                continue
            for fold_dir in sorted(os.listdir(os.path.join(base, model_dir))):
                f = os.path.join(base, model_dir, fold_dir, "benchmark_result.json")
                if os.path.isfile(f):
                    for hw_key, entry in load_json(f).items():
                        table[f"{name}|{model_dir}|{fold_dir}|{hw_key}"] = entry
    if output_file is not None:
        from anatomask_torch.plans.plans_handler import save_json
        save_json(table, output_file)
    return table

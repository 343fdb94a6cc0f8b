"""Model selection across configurations and ensembles. The port's own copy
of anatomask_tpu/evaluation/find_best_configuration.py (nnU-Net's
find_best_configuration.py and accumulate_cv_results.py): merge the
cross-validation predictions of each (trainer, plans, configuration), add
every two-model ensemble, rank by foreground-mean Dice, determine the
postprocessing of the winner, and write inference_information.json.
"""
from __future__ import annotations

import os
import shutil
from typing import List

from anatomask_torch.ensembling.ensemble import ensemble_crossvalidations
from anatomask_torch.evaluation.metrics import compute_metrics_on_folder
from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import PlansManager, load_json, save_json
from anatomask_torch.postprocessing.components import determine_postprocessing
from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name


def folder_for_model(dataset_name: str, trainer: str, plans: str, configuration: str) -> str:
    return os.path.join(require("results"), dataset_name, f"{trainer}__{plans}__{configuration}")


def accumulate_cv_results(
    trained_model_folder: str,
    merged_output_folder: str,
    folds: List[int] = (0, 1, 2, 3, 4),
    num_processes: int = 4,
    overwrite: bool = True,
):
    """Collect each fold's validation predictions into one folder and
    re-evaluate against ground truth."""
    if overwrite and os.path.isdir(merged_output_folder):
        shutil.rmtree(merged_output_folder)
    os.makedirs(merged_output_folder, exist_ok=True)
    dataset_json = load_json(os.path.join(trained_model_folder, "dataset.json"))
    plans_manager = PlansManager(os.path.join(trained_model_folder, "plans.json"))
    ending = dataset_json["file_ending"]

    for fold in folds:
        vdir = os.path.join(trained_model_folder, f"fold_{fold}", "validation")
        if not os.path.isdir(vdir):
            raise RuntimeError(f"fold {fold} has no validation folder ({vdir}); "
                               f"run training with final validation first")
        for f in os.listdir(vdir):
            if f.endswith(ending) or f.endswith(".npz"):
                shutil.copy(os.path.join(vdir, f), os.path.join(merged_output_folder, f))

    gt_dir = os.path.join(require("preprocessed"), plans_manager.dataset_name, "gt_segmentations")
    if not os.path.isdir(gt_dir):
        gt_dir = os.path.join(require("raw"), plans_manager.dataset_name, "labelsTr")
    lm = plans_manager.get_label_manager(dataset_json)
    return compute_metrics_on_folder(
        gt_dir, merged_output_folder,
        os.path.join(merged_output_folder, "summary.json"),
        plans_manager.image_reader_writer_class(), ending,
        lm.foreground_regions if lm.has_regions else lm.foreground_labels,
        lm.ignore_label, num_processes,
    )


def find_best_configuration(
    dataset_name_or_id,
    configurations: List[str] = ("2d", "3d_fullres", "3d_lowres", "3d_cascade_fullres"),
    trainers: List[str] = ("ATKTrainer",),
    plans: List[str] = ("ATKPlans",),
    folds: List[int] = (0, 1, 2, 3, 4),
    allow_ensembling: bool = True,
    num_processes: int = 4,
    overwrite: bool = True,
) -> dict:
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    results_base = os.path.join(require("results"), dataset_name)

    candidates = []
    for tr in trainers:
        for p in plans:
            for c in configurations:
                folder = folder_for_model(dataset_name, tr, p, c)
                if os.path.isdir(folder) and all(
                    os.path.isdir(os.path.join(folder, f"fold_{f}", "validation")) for f in folds
                ):
                    candidates.append({"trainer": tr, "plans": p, "configuration": c,
                                       "folder": folder})
    if not candidates:
        raise RuntimeError("No fully trained (trainer, plans, configuration) candidates found")

    results = []
    for cand in candidates:
        merged = os.path.join(results_base, "crossval_results_" +
                              f"{cand['trainer']}__{cand['plans']}__{cand['configuration']}")
        metrics = accumulate_cv_results(cand["folder"], merged, folds, num_processes, overwrite)
        results.append({**cand, "merged_folder": merged,
                        "dice": metrics["foreground_mean"]["Dice"], "ensemble": False})

    if allow_ensembling and len(candidates) >= 2:
        import itertools
        for a, b in itertools.combinations(range(len(candidates)), 2):
            name = (f"ensemble___{candidates[a]['trainer']}__{candidates[a]['plans']}__"
                    f"{candidates[a]['configuration']}___"
                    f"{candidates[b]['trainer']}__{candidates[b]['plans']}__"
                    f"{candidates[b]['configuration']}")
            out = os.path.join(results_base, "ensembles", name)
            try:
                ensemble_crossvalidations(
                    [candidates[a]["folder"], candidates[b]["folder"]], out, folds, num_processes)
            except RuntimeError:
                continue  # missing saved probabilities
            dataset_json = load_json(os.path.join(candidates[a]["folder"], "dataset.json"))
            pm = PlansManager(os.path.join(candidates[a]["folder"], "plans.json"))
            lm = pm.get_label_manager(dataset_json)
            gt_dir = os.path.join(require("preprocessed"), dataset_name, "gt_segmentations")
            if not os.path.isdir(gt_dir):
                gt_dir = os.path.join(require("raw"), dataset_name, "labelsTr")
            metrics = compute_metrics_on_folder(
                gt_dir, out, os.path.join(out, "summary.json"),
                pm.image_reader_writer_class(), dataset_json["file_ending"],
                lm.foreground_regions if lm.has_regions else lm.foreground_labels,
                lm.ignore_label, num_processes)
            results.append({
                "trainer": None, "plans": None, "configuration": name, "folder": out,
                "merged_folder": out, "dice": metrics["foreground_mean"]["Dice"],
                "ensemble": True,
                "members": [candidates[a], candidates[b]],
            })

    best = max(results, key=lambda r: r["dice"])

    # postprocessing for the winner
    ref_folder = best["folder"] if best["ensemble"] else best["folder"]
    dataset_json = load_json(os.path.join(
        candidates[0]["folder"], "dataset.json"))
    pm = PlansManager(os.path.join(candidates[0]["folder"], "plans.json"))
    lm = pm.get_label_manager(dataset_json)
    gt_dir = os.path.join(require("preprocessed"), dataset_name, "gt_segmentations")
    if not os.path.isdir(gt_dir):
        gt_dir = os.path.join(require("raw"), dataset_name, "labelsTr")
    pp_fns, pp_metrics = determine_postprocessing(
        best["merged_folder"], gt_dir, pm.image_reader_writer_class(),
        dataset_json["file_ending"],
        lm.foreground_regions if lm.has_regions else lm.foreground_labels,
        lm.ignore_label, num_processes=num_processes,
    )

    info = {
        "folds": list(folds),
        "dataset_name_or_id": str(dataset_name_or_id),
        "considered": [
            {k: v for k, v in r.items() if k not in ("members",)} for r in results
        ],
        "best_model_or_ensemble": {
            "configuration": best["configuration"],
            "trainer": best.get("trainer"),
            "plans": best.get("plans"),
            "ensemble": best["ensemble"],
            "dice_before_postprocessing": best["dice"],
            "dice_after_postprocessing": pp_metrics["foreground_mean"]["Dice"],
            "postprocessing": [
                {"fn": e["fn"], "labels_or_regions": [
                    list(l) if isinstance(l, (tuple, list)) else l
                    for l in e["labels_or_regions"]]}
                for e in pp_fns
            ],
        },
    }
    save_json(info, os.path.join(results_base, "inference_information.json"))

    print("*** Best configuration ***")
    print(f"  {best['configuration']} (ensemble={best['ensemble']}) "
          f"Dice {best['dice']:.4f} -> {pp_metrics['foreground_mean']['Dice']:.4f} after pp")
    return info

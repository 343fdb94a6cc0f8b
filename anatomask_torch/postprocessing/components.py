"""Connected-component postprocessing. The port's own copy of
anatomask_tpu/postprocessing/components.py (nnU-Net's
remove_connected_components.py): keep only the largest component of a label
or region; determine_postprocessing tries keep-largest-component on the
foreground union, then per class or region, and keeps each step only where
the foreground-mean Dice does not drop; apply_postprocessing(_to_folder);
the decision is stored as postprocessing.json. Host scipy.ndimage.label, a
folder's cases one after another as in JAX.
"""
from __future__ import annotations

import os
import shutil
from typing import List, Optional, Tuple, Union

import numpy as np
from scipy.ndimage import label as cc_label

from anatomask_torch.evaluation.metrics import compute_metrics_on_folder, label_or_region_to_mask
from anatomask_torch.plans.plans_handler import load_json, save_json


def remove_all_but_largest_component(binary_mask: np.ndarray) -> np.ndarray:
    labeled, n = cc_label(binary_mask)
    if n <= 1:
        return binary_mask
    sizes = np.bincount(labeled.ravel())
    sizes[0] = 0
    return labeled == int(np.argmax(sizes))


def remove_all_but_largest_component_from_segmentation(
    segmentation: np.ndarray,
    labels_or_regions: Union[int, Tuple[int, ...], List],
    background_label: int = 0,
) -> np.ndarray:
    """For each given label/region: keep only its largest connected component,
    relabeling removed voxels to background."""
    if not isinstance(labels_or_regions, list):
        labels_or_regions = [labels_or_regions]
    seg = np.copy(segmentation)
    for l_or_r in labels_or_regions:
        mask = label_or_region_to_mask(segmentation, l_or_r)
        if not mask.any():
            continue
        keep = remove_all_but_largest_component(mask)
        seg[mask & ~keep] = background_label
    return seg


def apply_postprocessing(segmentation: np.ndarray, pp_fns_args: List[dict]) -> np.ndarray:
    for entry in pp_fns_args:
        assert entry["fn"] == "remove_all_but_largest_component_from_segmentation"
        segmentation = remove_all_but_largest_component_from_segmentation(
            segmentation, entry["labels_or_regions"])
    return segmentation


def _process_case(args):
    in_file, out_file, pp_fns_args, rw_class = args
    rw = rw_class()
    seg, props = rw.read_seg(in_file)
    seg = apply_postprocessing(seg[0], pp_fns_args)
    rw.write_seg(seg, out_file, props)


def apply_postprocessing_to_folder(
    input_folder: str,
    output_folder: str,
    pp_fns_args: List[dict],
    image_reader_writer,
    file_ending: str,
    num_processes: int = 4,
):
    os.makedirs(output_folder, exist_ok=True)
    files = sorted(f for f in os.listdir(input_folder) if f.endswith(file_ending))
    jobs = [
        (os.path.join(input_folder, f), os.path.join(output_folder, f),
         pp_fns_args, type(image_reader_writer))
        for f in files
    ]
    for j in jobs:
        _process_case(j)


def determine_postprocessing(
    folder_predictions: str,
    folder_ref: str,
    image_reader_writer,
    file_ending: str,
    labels_or_regions,
    ignore_label: Optional[int] = None,
    plans_manager=None,
    dataset_json: Optional[dict] = None,
    num_processes: int = 4,
    keep_postprocessed_files: bool = True,
) -> Tuple[List[dict], dict]:
    """Empirically decide which keep-largest-component steps help.

    Stage 1: treat all foreground as one region; keep the step if fg-mean Dice
    does not degrade. Stage 2: per label/region. Returns (pp_fns_args list,
    final metrics). Writes postprocessing.json next to the predictions.
    """
    base_metrics = compute_metrics_on_folder(
        folder_ref, folder_predictions, None, image_reader_writer, file_ending,
        labels_or_regions, ignore_label, num_processes,
    )
    pp_fns_args: List[dict] = []
    current_folder = folder_predictions
    tmp_root = folder_predictions.rstrip(os.sep) + "_postprocessed_tmp"

    # stage 1: foreground union
    fg_union: List = []
    for l in labels_or_regions:
        if isinstance(l, (tuple, list)):
            fg_union.extend(l)
        else:
            fg_union.append(l)
    fg_union = [tuple(sorted(set(fg_union)))]

    candidates = [
        {"fn": "remove_all_but_largest_component_from_segmentation",
         "labels_or_regions": fg_union, "stage": "foreground"},
        {"fn": "remove_all_but_largest_component_from_segmentation",
         "labels_or_regions": list(labels_or_regions), "stage": "per_class"},
    ]
    current_metrics = base_metrics
    for i, cand in enumerate(candidates):
        trial_folder = f"{tmp_root}_{i}"
        apply_postprocessing_to_folder(
            current_folder, trial_folder,
            [{k: v for k, v in cand.items() if k != "stage"}],
            image_reader_writer, file_ending, num_processes,
        )
        trial_metrics = compute_metrics_on_folder(
            folder_ref, trial_folder, None, image_reader_writer, file_ending,
            labels_or_regions, ignore_label, num_processes,
        )
        if trial_metrics["foreground_mean"]["Dice"] >= current_metrics["foreground_mean"]["Dice"]:
            pp_fns_args.append({k: v for k, v in cand.items() if k != "stage"})
            current_metrics = trial_metrics
            current_folder = trial_folder
        else:
            shutil.rmtree(trial_folder, ignore_errors=True)

    final_folder = folder_predictions.rstrip(os.sep) + "_postprocessed"
    if keep_postprocessed_files:
        if os.path.isdir(final_folder):
            shutil.rmtree(final_folder)
        if current_folder == folder_predictions:
            shutil.copytree(folder_predictions, final_folder,
                            ignore=shutil.ignore_patterns("*.json"))
        else:
            shutil.move(current_folder, final_folder)
    for i in range(len(candidates)):
        shutil.rmtree(f"{tmp_root}_{i}", ignore_errors=True)

    serializable = [
        {"fn": e["fn"], "labels_or_regions": [
            list(l) if isinstance(l, (tuple, list)) else l for l in e["labels_or_regions"]]}
        for e in pp_fns_args
    ]
    save_json({"pp_fns_args": serializable},
              os.path.join(folder_predictions, "postprocessing.json"))
    return pp_fns_args, current_metrics


def load_postprocessing_description(path: str) -> List[dict]:
    desc = load_json(path)["pp_fns_args"]
    for e in desc:
        e["labels_or_regions"] = [
            tuple(l) if isinstance(l, list) else l for l in e["labels_or_regions"]]
    return desc

"""Segmentation metrics. The port's own copy of
anatomask_tpu/evaluation/metrics.py (nnU-Net's evaluate_predictions:
`compute_metrics` per case and label or region: Dice, IoU, TP/FP/FN/TN,
n_pred/n_ref, with an optional ignore label; `compute_metrics_on_folder`
over a thread pool, writing summary.json with metric_per_case, the per-class
'mean' and 'foreground_mean'). Host numpy only.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from anatomask_torch.plans.plans_handler import save_json


def label_or_region_to_mask(segmentation: np.ndarray, label_or_region) -> np.ndarray:
    if isinstance(label_or_region, (tuple, list)):
        return np.isin(segmentation, np.asarray(label_or_region))
    return segmentation == label_or_region


def compute_tp_fp_fn_tn(mask_ref: np.ndarray, mask_pred: np.ndarray,
                        ignore_mask: Optional[np.ndarray] = None):
    use = np.ones_like(mask_ref, dtype=bool) if ignore_mask is None else ~ignore_mask
    tp = int(np.sum(mask_ref & mask_pred & use))
    fp = int(np.sum(~mask_ref & mask_pred & use))
    fn = int(np.sum(mask_ref & ~mask_pred & use))
    tn = int(np.sum(~mask_ref & ~mask_pred & use))
    return tp, fp, fn, tn


def compute_metrics(reference_file: str, prediction_file: str, image_reader_writer,
                    labels_or_regions, ignore_label: Optional[int] = None) -> dict:
    seg_ref = image_reader_writer.read_seg(reference_file)[0][0]
    seg_pred = image_reader_writer.read_seg(prediction_file)[0][0]
    ignore_mask = (seg_ref == ignore_label) if ignore_label is not None else None
    results = {"reference_file": reference_file, "prediction_file": prediction_file,
               "metrics": {}}
    for r in labels_or_regions:
        key = str(r) if isinstance(r, (tuple, list)) else r
        tp, fp, fn, tn = compute_tp_fp_fn_tn(label_or_region_to_mask(seg_ref, r),
                                             label_or_region_to_mask(seg_pred, r), ignore_mask)
        if tp + fp + fn == 0:
            dice = iou = np.nan
        else:
            dice = 2 * tp / (2 * tp + fp + fn)
            iou = tp / (tp + fp + fn)
        results["metrics"][key] = {"Dice": dice, "IoU": iou, "TP": tp, "FP": fp, "FN": fn,
                                   "TN": tn, "n_pred": fp + tp, "n_ref": fn + tp}
    return results


def compute_metrics_on_folder(folder_ref: str, folder_pred: str, output_file: Optional[str],
                              image_reader_writer, file_ending: str, labels_or_regions,
                              ignore_label: Optional[int] = None, num_processes: int = 4,
                              chill: bool = True) -> dict:
    files_pred = sorted(f for f in os.listdir(folder_pred) if f.endswith(file_ending))
    files_ref = sorted(f for f in os.listdir(folder_ref) if f.endswith(file_ending))
    if not chill:
        assert all(f in files_ref for f in files_pred), (
            "Not all files in folder_pred exist in folder_ref")
    pairs = [(os.path.join(folder_ref, f), os.path.join(folder_pred, f)) for f in files_pred]

    def one(pair):
        return compute_metrics(pair[0], pair[1], image_reader_writer, labels_or_regions,
                               ignore_label)

    if num_processes > 1 and len(pairs) > 1:
        with ThreadPoolExecutor(max_workers=num_processes) as ex:
            results = list(ex.map(one, pairs))
    else:
        results = [one(p) for p in pairs]

    metric_list = (list(next(iter(results[0]["metrics"].values())).keys())
                   if results else [])
    means = {}
    for r in labels_or_regions:
        key = str(r) if isinstance(r, (tuple, list)) else r
        means[key] = {m: float(np.nanmean([res["metrics"][key][m] for res in results]))
                      for m in metric_list}
    foreground_mean = {m: float(np.nanmean([means[k][m] for k in means])) for m in metric_list}
    result = {"metric_per_case": results, "mean": means, "foreground_mean": foreground_mean}
    if output_file is not None:
        save_json(_to_serializable(result), output_file, sort_keys=False)
    return result


def _to_serializable(obj):
    if isinstance(obj, dict):
        return {str(k): _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_serializable(v) for v in obj]
    if isinstance(obj, (np.floating, float)):
        v = float(obj)
        return None if np.isnan(v) else v
    if isinstance(obj, np.integer):
        return int(obj)
    return obj

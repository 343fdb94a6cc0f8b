"""Probability ensembling. The port's own copy of
anatomask_tpu/ensembling/ensemble.py (nnU-Net's ensemble.py): average saved
.npz probability maps over configurations (ensemble_folders) or over
cross-validation folds (ensemble_crossvalidations), convert them to
segmentations and export them. Host numpy, one case after another as in
JAX (num_processes is taken for the same signature and not used).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
from anatomask_torch.plans.label_handling import LabelManager
from anatomask_torch.plans.plans_handler import PlansManager, load_json
from anatomask_torch.preprocessing.preprocessor import load_properties


def average_probabilities(list_of_files: List[str]) -> np.ndarray:
    assert list_of_files, "need at least one file"
    avg = None
    for f in list_of_files:
        with np.load(f) as z:
            probs = z["probabilities"].astype(np.float32)
        avg = probs if avg is None else avg + probs
    return avg / len(list_of_files)


def merge_files_and_export(
    files: List[str],
    properties_base: str,
    output_file_truncated: str,
    plans_manager: PlansManager,
    dataset_json: dict,
    label_manager: LabelManager,
    save_probabilities: bool = False,
):
    probs = average_probabilities(files)
    properties = load_properties(properties_base)
    seg = label_manager.convert_probabilities_to_segmentation(probs)
    # probabilities are saved on the original grid (the export has undone
    # cropping and transpose), so they are written as they are
    rw = determine_reader_writer_from_dataset_json(dataset_json)()
    rw.write_seg(np.asarray(seg), output_file_truncated + dataset_json["file_ending"], properties)
    if save_probabilities:
        np.savez_compressed(output_file_truncated + ".npz", probabilities=probs)


def ensemble_folders(
    list_of_input_folders: List[str],
    output_folder: str,
    save_merged_probabilities: bool = False,
    num_processes: int = 4,
):
    """Each input folder must contain per-case .npz probability files (produced
    by prediction with save_probabilities=True) plus dataset/plans json."""
    os.makedirs(output_folder, exist_ok=True)
    dataset_json = load_json(os.path.join(list_of_input_folders[0], "dataset.json"))
    plans_manager = PlansManager(os.path.join(list_of_input_folders[0], "plans.json"))
    label_manager = plans_manager.get_label_manager(dataset_json)

    files_per_folder = [
        {f[:-4] for f in os.listdir(fl)
         if f.endswith(".npz") and not f.endswith(".props.npz")}
        for fl in list_of_input_folders
    ]
    common = set.intersection(*files_per_folder)
    assert common, "no common cases found across input folders"
    for ident in sorted(common):
        merge_files_and_export(
            [os.path.join(fl, ident + ".npz") for fl in list_of_input_folders],
            os.path.join(list_of_input_folders[0], ident),
            os.path.join(output_folder, ident),
            plans_manager, dataset_json, label_manager, save_merged_probabilities,
        )


def ensemble_crossvalidations(
    list_of_trained_model_folders: List[str],
    output_folder: str,
    folds: List[int] = (0, 1, 2, 3, 4),
    num_processes: int = 4,
):
    """Merge validation predictions of the requested folds of each model; cases
    appearing in several folds' validation sets are averaged."""
    os.makedirs(output_folder, exist_ok=True)
    dataset_json = load_json(os.path.join(list_of_trained_model_folders[0], "dataset.json"))
    plans_manager = PlansManager(os.path.join(list_of_trained_model_folders[0], "plans.json"))
    label_manager = plans_manager.get_label_manager(dataset_json)

    per_case: dict = {}
    for model in list_of_trained_model_folders:
        for fold in folds:
            vdir = os.path.join(model, f"fold_{fold}", "validation")
            if not os.path.isdir(vdir):
                raise RuntimeError(f"expected validation folder {vdir}")
            for f in os.listdir(vdir):
                if f.endswith(".npz") and not f.endswith(".props.npz"):
                    ident = f[:-4]
                    per_case.setdefault(ident, []).append(os.path.join(vdir, f))

    for ident, files in sorted(per_case.items()):
        merge_files_and_export(
            files, files[0][:-4], os.path.join(output_folder, ident),
            plans_manager, dataset_json, label_manager,
        )

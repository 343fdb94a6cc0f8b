"""Raw dataset integrity check. The port's own copy of
anatomask_tpu/planning/verify_integrity.py (nnU-Net's
verify_dataset_integrity.py): dataset.json sanity (labels declared,
consecutive integers from 0), then per case: the image and label files
exist, the label values are a subset of the declared labels, image and
segmentation agree in shape and spacing, no NaNs.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
from anatomask_torch.plans.label_handling import LabelManager
from anatomask_torch.plans.plans_handler import load_json
from anatomask_torch.utils.helpers import get_case_identifiers_from_raw, get_filenames_of_case


def verify_labels(label_file: str, rw, expected_labels: List[int]) -> List[str]:
    errors = []
    seg, _ = rw.read_seg(label_file)
    found = np.unique(seg)
    bad = [int(v) for v in found if int(v) not in expected_labels]
    if bad:
        errors.append(f"{label_file}: unexpected label values {bad} "
                      f"(expected subset of {expected_labels})")
    if np.any(np.isnan(seg)):
        errors.append(f"{label_file}: segmentation contains NaN")
    return errors


def check_case(image_files: List[str], label_file: str, rw, expected_num_channels: int) -> List[str]:
    errors = []
    for f in image_files + [label_file]:
        if not os.path.isfile(f):
            errors.append(f"missing file: {f}")
    if errors:
        return errors
    images, props_img = rw.read_images(image_files)
    seg, props_seg = rw.read_seg(label_file)
    if images.shape[0] != expected_num_channels:
        errors.append(f"{image_files[0]}: expected {expected_num_channels} channels, "
                      f"got {images.shape[0]}")
    if images.shape[1:] != seg.shape[1:]:
        errors.append(f"{image_files[0]}: image shape {images.shape[1:]} != "
                      f"seg shape {seg.shape[1:]}")
    if not np.allclose(props_img["spacing"], props_seg["spacing"], rtol=1e-3):
        errors.append(f"{image_files[0]}: image spacing {props_img['spacing']} != "
                      f"seg spacing {props_seg['spacing']}")
    if np.any(np.isnan(images)):
        errors.append(f"{image_files[0]}: image contains NaN")
    return errors


def verify_dataset_integrity(raw_dataset_folder: str, num_processes: int = 4) -> List[str]:
    """The list of errors found (empty: the dataset is sound); raises on a
    dataset.json that cannot be planned at all."""
    dataset_json = load_json(os.path.join(raw_dataset_folder, "dataset.json"))
    assert "labels" in dataset_json, "dataset.json must declare labels"
    assert "file_ending" in dataset_json, "dataset.json must declare file_ending"
    assert "numTraining" in dataset_json, "dataset.json must declare numTraining"
    lm = LabelManager(dataset_json["labels"], dataset_json.get("regions_class_order"))
    expected_labels = list(lm.all_labels)
    if lm.has_ignore_label:
        expected_labels.append(lm.ignore_label)
    if sorted(lm.all_labels) != list(range(len(lm.all_labels))):
        raise RuntimeError(
            f"Labels must be consecutive integers starting at 0, got {lm.all_labels}")

    idents = get_case_identifiers_from_raw(raw_dataset_folder, dataset_json)
    if len(idents) != dataset_json["numTraining"]:
        raise RuntimeError(
            f"numTraining={dataset_json['numTraining']} but found {len(idents)} cases")
    n_channels = len(dataset_json.get("channel_names", dataset_json.get("modality")))
    rw = determine_reader_writer_from_dataset_json(dataset_json)()

    errors: List[str] = []
    for ident in idents:
        images, seg = get_filenames_of_case(raw_dataset_folder, ident, dataset_json)
        if seg is None:
            errors.append(f"{ident}: missing label file")
            continue
        errors.extend(check_case(images, seg, rw, n_channels))
        errors.extend(verify_labels(seg, rw, expected_labels))
    if errors:
        for e in errors:
            print("INTEGRITY ERROR:", e)
    else:
        print("Dataset OK")
    return errors

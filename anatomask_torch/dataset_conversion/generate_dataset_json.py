"""dataset.json generation. The port's own copy of
anatomask_tpu/dataset_conversion/generate_dataset_json.py (nnU-Net's
generate_dataset_json.py): channel names (naming the normalization scheme),
labels with regions and an ignore label, numTraining, file_ending, and the
optional regions_class_order and overwrite_image_reader_writer.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

from anatomask_torch.plans.plans_handler import save_json


def generate_dataset_json(
    output_folder: str,
    channel_names: Dict[str, str],
    labels: dict,
    num_training_cases: int,
    file_ending: str,
    regions_class_order: Optional[tuple] = None,
    dataset_name: Optional[str] = None,
    reference: Optional[str] = None,
    release: Optional[str] = None,
    license: Optional[str] = None,
    description: Optional[str] = None,
    overwrite_image_reader_writer: Optional[str] = None,
    **kwargs,
) -> dict:
    has_regions = any(isinstance(v, (tuple, list)) and len(v) > 1 for v in labels.values())
    if has_regions:
        assert regions_class_order is not None, (
            "regions_class_order is required for region-based labels"
        )
    # normalize label values to plain ints/lists for json
    labels = {
        k: ([int(i) for i in v] if isinstance(v, (tuple, list)) else int(v))
        for k, v in labels.items()
    }
    dataset_json = {
        "channel_names": {str(k): v for k, v in channel_names.items()},
        "labels": labels,
        "numTraining": num_training_cases,
        "file_ending": file_ending,
    }
    if dataset_name is not None:
        dataset_json["name"] = dataset_name
    if reference is not None:
        dataset_json["reference"] = reference
    if release is not None:
        dataset_json["release"] = release
    if license is not None:
        dataset_json["licence"] = license
    if description is not None:
        dataset_json["description"] = description
    if regions_class_order is not None:
        dataset_json["regions_class_order"] = list(regions_class_order)
    if overwrite_image_reader_writer is not None:
        dataset_json["overwrite_image_reader_writer"] = overwrite_image_reader_writer
    dataset_json.update(kwargs)
    os.makedirs(output_folder, exist_ok=True)
    save_json(dataset_json, os.path.join(output_folder, "dataset.json"), sort_keys=False)
    return dataset_json

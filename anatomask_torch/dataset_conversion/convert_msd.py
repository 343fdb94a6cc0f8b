"""Medical Segmentation Decathlon -> framework dataset layout.

After nnU-Net's nnunetv2/dataset_conversion/convert_MSD_dataset.py
— MSD Task folders (imagesTr with 4D multi-channel files or 3D single-channel,
labelsTr, dataset.json with 'modality'/'labels' in MSD schema) converted to the
DatasetXXX_Name layout with per-channel _0000 suffixed files and a framework
dataset.json.

Counterpart of anatomask_tpu/dataset_conversion/convert_msd.py, copied function for function.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.imageio.nifti import read_nifti, write_nifti
from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import load_json


def _split_4d_nifti(src: str, out_dir: str, ident: str, ending: str):
    data, hdr = read_nifti(src)
    if data.ndim == 3:
        shutil.copy(src, os.path.join(out_dir, f"{ident}_0000{ending}"))
        return 1
    assert data.ndim == 4, f"expected 3D or 4D image, got {data.shape}"
    for c in range(data.shape[3]):
        write_nifti(os.path.join(out_dir, f"{ident}_{c:04d}{ending}"),
                    np.ascontiguousarray(data[..., c]), header=hdr)
    return data.shape[3]


def convert_msd_dataset(
    source_folder: str,
    overwrite_target_id: Optional[int] = None,
    num_processes: int = 4,
) -> str:
    """source_folder: an MSD TaskXX_Name directory. Returns the new dataset dir."""
    task_name = os.path.basename(source_folder.rstrip(os.sep))
    assert task_name.startswith("Task"), f"expected MSD TaskXX_Name folder, got {task_name}"
    task_id = int(task_name[4:6])
    name = task_name[7:] if task_name[6] == "_" else task_name.split("_", 1)[1]
    dataset_id = overwrite_target_id if overwrite_target_id is not None else task_id
    dataset_name = f"Dataset{dataset_id:03d}_{name}"

    msd_json = load_json(os.path.join(source_folder, "dataset.json"))
    ending = ".nii.gz"
    out_dir = os.path.join(require("raw"), dataset_name)
    os.makedirs(os.path.join(out_dir, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "labelsTr"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "imagesTs"), exist_ok=True)

    n_channels = None
    n_train = 0
    for entry in msd_json["training"]:
        img = os.path.join(source_folder, entry["image"].lstrip("./"))
        lab = os.path.join(source_folder, entry["label"].lstrip("./"))
        ident = os.path.basename(img)[: -len(ending)]
        n_channels = _split_4d_nifti(img, os.path.join(out_dir, "imagesTr"), ident, ending)
        shutil.copy(lab, os.path.join(out_dir, "labelsTr", f"{ident}{ending}"))
        n_train += 1
    for entry in msd_json.get("test", []):
        img = os.path.join(source_folder, entry.lstrip("./") if isinstance(entry, str)
                           else entry["image"].lstrip("./"))
        ident = os.path.basename(img)[: -len(ending)]
        _split_4d_nifti(img, os.path.join(out_dir, "imagesTs"), ident, ending)

    # MSD schema: modality {idx: name}, labels {value: name} -> ours: inverted
    modality = msd_json.get("modality", {"0": "CT"})
    channel_names = {str(k): v for k, v in modality.items()}
    labels = {v if isinstance(v, str) else str(v): int(k)
              for k, v in msd_json["labels"].items()}
    if "background" not in labels:
        # MSD labels map value->name; ensure background key exists
        inv = {int(k): v for k, v in msd_json["labels"].items()}
        labels = {name: value for value, name in sorted(inv.items())}
    generate_dataset_json(
        out_dir, channel_names, labels, n_train, ending,
        dataset_name=dataset_name, reference=msd_json.get("reference"),
        release=msd_json.get("release"), license=msd_json.get("licence"),
        description=msd_json.get("description"),
    )
    return out_dir

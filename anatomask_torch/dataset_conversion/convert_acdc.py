"""ACDC cardiac MRI converter.

After nnU-Net's nnunetv2/dataset_conversion/Dataset027_ACDC.py
— ACDC ships per-patient folders with multiple time frames; the ED and ES
frames (the ones that have *_gt segmentations) become independent training
cases; labels {0: bg, 1: RV, 2: myocardium, 3: LV}.

Counterpart of anatomask_tpu/dataset_conversion/convert_acdc.py, copied function for function.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.paths import require


def convert_acdc_dataset(source_folder: str, dataset_id: int = 27) -> str:
    """source_folder: 'training/' dir with patientXXX/ subfolders containing
    patientXXX_frameYY.nii.gz + patientXXX_frameYY_gt.nii.gz."""
    name = f"Dataset{dataset_id:03d}_ACDC"
    out = os.path.join(require("raw"), name)
    os.makedirs(os.path.join(out, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(out, "labelsTr"), exist_ok=True)

    n = 0
    for patient in sorted(os.listdir(source_folder)):
        pdir = os.path.join(source_folder, patient)
        if not os.path.isdir(pdir):
            continue
        for f in sorted(os.listdir(pdir)):
            if f.endswith("_gt.nii.gz"):
                frame = f[: -len("_gt.nii.gz")]
                img = os.path.join(pdir, frame + ".nii.gz")
                if not os.path.isfile(img):
                    continue
                shutil.copy(img, os.path.join(out, "imagesTr", f"{frame}_0000.nii.gz"))
                shutil.copy(os.path.join(pdir, f),
                            os.path.join(out, "labelsTr", f"{frame}.nii.gz"))
                n += 1

    generate_dataset_json(
        out, {"0": "cineMRI"},
        {"background": 0, "RV": 1, "MLV": 2, "LVC": 3},
        n, ".nii.gz", dataset_name=name,
    )
    return out

"""Synthetic datasets covering the full label-scheme matrix for integration
tests.

After nnU-Net's nnunetv2/dataset_conversion/
datasets_for_integration_tests/Dataset99{6,7,8,9}_*.py — four dataset variants
derived from one base: standard labels (999), ignore label (998), regions
(997), regions+ignore (996); plus the dummy dataset generator (988).

Counterpart of anatomask_tpu/dataset_conversion/integration_test_datasets.py, copied function for function.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.imageio.nifti import write_nifti
from anatomask_torch.paths import require


def _base_case(rng, shape):
    img = np.zeros(shape, dtype=np.float32)
    seg = np.zeros(shape, dtype=np.uint8)
    sl = tuple(slice(2, s - 2) for s in shape)
    img[sl] = rng.rand(*[s - 4 for s in shape]) * 100 + 20
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    for lab in (1, 2):
        c = [rng.randint(6, s - 6) for s in shape]
        r = rng.randint(3, 6)
        blob = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < r ** 2
        seg[blob] = lab
        img[blob] += 80 * lab
    return img, seg


def generate_integration_test_dataset(
    dataset_id: int,
    scheme: str,
    num_cases: int = 8,
    shape: Tuple[int, int, int] = (24, 26, 28),
    seed: int = 1234,
) -> str:
    """scheme: 'labels' | 'ignore' | 'regions' | 'regions_ignore'."""
    rng = np.random.RandomState(seed)
    name = {
        "labels": "IntegrationTest_Labels",
        "ignore": "IntegrationTest_Ignore",
        "regions": "IntegrationTest_Regions",
        "regions_ignore": "IntegrationTest_RegionsIgnore",
    }[scheme]
    dataset_name = f"Dataset{dataset_id:03d}_{name}"
    out = os.path.join(require("raw"), dataset_name)
    os.makedirs(os.path.join(out, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(out, "labelsTr"), exist_ok=True)

    for i in range(num_cases):
        img, seg = _base_case(rng, shape)
        if scheme in ("ignore", "regions_ignore"):
            # mark a border slab as unannotated
            seg[:, :, : shape[2] // 5] = 3
        ident = f"case_{i:03d}"
        write_nifti(os.path.join(out, "imagesTr", f"{ident}_0000.nii.gz"),
                    img.transpose(2, 1, 0))
        write_nifti(os.path.join(out, "labelsTr", f"{ident}.nii.gz"),
                    seg.transpose(2, 1, 0))

    if scheme == "labels":
        labels = {"background": 0, "class1": 1, "class2": 2}
        regions = None
    elif scheme == "ignore":
        labels = {"background": 0, "class1": 1, "class2": 2, "ignore": 3}
        regions = None
    elif scheme == "regions":
        labels = {"background": 0, "whole": (1, 2), "core": 2}
        regions = (1, 2)
    else:  # regions_ignore
        labels = {"background": 0, "whole": (1, 2), "core": 2, "ignore": 3}
        regions = (1, 2)

    generate_dataset_json(out, {"0": "CT"}, labels, num_cases, ".nii.gz",
                          regions_class_order=regions, dataset_name=dataset_name)
    return out


def generate_all_integration_test_datasets(base_id: int = 996):
    """999 labels, 998 ignore, 997 regions, 996 regions+ignore (reference ids)."""
    out = []
    for offset, scheme in enumerate(["regions_ignore", "regions", "ignore", "labels"]):
        out.append(generate_integration_test_dataset(base_id + offset, scheme))
    return out

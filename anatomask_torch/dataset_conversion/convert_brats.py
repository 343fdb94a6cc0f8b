"""BraTS-style dataset converter (region-based labels + label permutation).

After nnU-Net's nnunetv2/dataset_conversion/
Dataset137_BraTS21.py. BraTS ships 4 modalities per case and labels
{0: bg, 1: necrotic/non-enhancing core, 2: edema, 3: enhancing} (BraTS'21;
older releases used 4 for enhancing). The reference PERMUTES labels for
training (Dataset137_BraTS21.py:24-27):

    BraTS 2 (edema)     -> train 1
    BraTS 1 (necrotic)  -> train 2
    BraTS 3 (enhancing) -> train 3

so that region-based heads read whole=(1,2,3), core=(2,3), enhancing=(3,)
(Dataset137_BraTS21.py:88-96). Predictions must be converted BACK to the
BraTS convention before submission (convert_labels_back_to_BraTS :33-38);
`convert_labels_back_to_brats` / `convert_folder_back_to_brats` mirror that.

Counterpart of anatomask_tpu/dataset_conversion/convert_brats.py, copied function for function.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import numpy as np

from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.imageio.nifti import read_nifti, write_nifti
from anatomask_torch.paths import require

# legacy (<=2020) per-case file suffixes and BraTS'21 suffixes; both accepted
BRATS_MODALITIES = ("t1", "t1ce", "t2", "flair")
BRATS21_MODALITIES = ("t1n", "t1c", "t2w", "t2f")


def remap_brats_labels(seg: np.ndarray) -> np.ndarray:
    """BraTS -> nnU-Net training convention, the reference permutation
    (Dataset137_BraTS21.py:24-27): {2->1, 1->2, 3->3}. Legacy label 4
    (enhancing in BraTS<=2020) is treated as 3 first, so both conventions
    convert identically."""
    seg = np.where(seg == 4, 3, seg)
    out = np.zeros_like(seg)
    out[seg == 3] = 3
    out[seg == 2] = 1
    out[seg == 1] = 2
    return out


def convert_labels_back_to_brats(seg: np.ndarray) -> np.ndarray:
    """Inverse permutation {1->2, 2->1, 3->3} for submitting predictions
    (reference convert_labels_back_to_BraTS, Dataset137_BraTS21.py:33-38)."""
    out = np.zeros_like(seg)
    out[seg == 1] = 2
    out[seg == 3] = 3
    out[seg == 2] = 1
    return out


def convert_folder_back_to_brats(input_folder: str, output_folder: str) -> int:
    """Convert every .nii.gz prediction in input_folder back to the BraTS
    labeling convention (reference
    convert_folder_with_preds_back_to_BraTS_labeling_convention :50-57).
    Returns the number of files written."""
    os.makedirs(output_folder, exist_ok=True)
    files = sorted(f for f in os.listdir(input_folder) if f.endswith(".nii.gz"))
    for f in files:
        seg, hdr = read_nifti(os.path.join(input_folder, f))
        write_nifti(os.path.join(output_folder, f),
                    convert_labels_back_to_brats(seg).astype(np.uint8),
                    header=hdr)
    return len(files)


def _case_files(cdir: str, case: str):
    """Resolve (modality image paths, seg path) for a case folder, accepting
    both the legacy '<case>_t1.nii.gz'/'<case>_seg.nii.gz' layout and the
    BraTS'21 '<case>-t1n.nii.gz'/'<case>-seg.nii.gz' layout
    (Dataset137_BraTS21.py:78-83)."""
    # decide on the FULL file set, not the seg alone — a
    # folder with a legacy seg but BraTS'21 modality names (or a missing
    # modality) must fall through / be skipped, not crash mid-copy.
    legacy = [os.path.join(cdir, f"{case}_{m}.nii.gz") for m in BRATS_MODALITIES]
    if (os.path.isfile(os.path.join(cdir, f"{case}_seg.nii.gz"))
            and all(os.path.isfile(p) for p in legacy)):
        return legacy, os.path.join(cdir, f"{case}_seg.nii.gz")
    b21 = [os.path.join(cdir, f"{case}-{m}.nii.gz") for m in BRATS21_MODALITIES]
    if (os.path.isfile(os.path.join(cdir, f"{case}-seg.nii.gz"))
            and all(os.path.isfile(p) for p in b21)):
        return b21, os.path.join(cdir, f"{case}-seg.nii.gz")
    if (os.path.isfile(os.path.join(cdir, f"{case}_seg.nii.gz"))
            or os.path.isfile(os.path.join(cdir, f"{case}-seg.nii.gz"))):
        import warnings
        warnings.warn(f"BraTS case {case}: seg present but modality set "
                      "incomplete under both naming conventions; skipping")
    return None, None


def convert_brats_dataset(
    source_folder: str,
    dataset_id: int = 137,
    dataset_name: str = "BraTS2021",
    use_regions: bool = True,
) -> str:
    """source_folder: per-case subfolders '<case>/' containing the 4 modality
    images + a segmentation (legacy or BraTS'21 naming, see _case_files)."""
    name = f"Dataset{dataset_id:03d}_{dataset_name}"
    out = os.path.join(require("raw"), name)
    os.makedirs(os.path.join(out, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(out, "labelsTr"), exist_ok=True)

    cases = sorted(
        d for d in os.listdir(source_folder)
        if os.path.isdir(os.path.join(source_folder, d))
    )
    n = 0
    for case in cases:
        cdir = os.path.join(source_folder, case)
        mod_files, seg_file = _case_files(cdir, case)
        if seg_file is None:
            continue
        for c, src in enumerate(mod_files):
            shutil.copy(src, os.path.join(out, "imagesTr", f"{case}_{c:04d}.nii.gz"))
        seg, hdr = read_nifti(seg_file)
        write_nifti(os.path.join(out, "labelsTr", f"{case}.nii.gz"),
                    remap_brats_labels(seg).astype(np.uint8), header=hdr)
        n += 1

    channel_names = {"0": "T1", "1": "T1ce", "2": "T2", "3": "Flair"}
    if use_regions:
        # reference region definition under the PERMUTED labels
        # (Dataset137_BraTS21.py:88-96)
        labels = {"background": 0, "whole_tumor": (1, 2, 3), "tumor_core": (2, 3),
                  "enhancing_tumor": (3,)}
        regions = (1, 2, 3)
    else:
        # permuted convention: 1=edema, 2=necrosis, 3=enhancing
        labels = {"background": 0, "edema": 1, "necrosis": 2, "enhancing": 3}
        regions = None
    generate_dataset_json(out, channel_names, labels, n, ".nii.gz",
                          regions_class_order=regions, dataset_name=name)
    return out

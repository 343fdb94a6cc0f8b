"""Challenge dataset converters.

After nnU-Net's converter scripts (behavior, naming,
labels, custom splits), re-expressed against this repo's IO/paths:
- KiTS2023:        nnU-Net's nnunetv2/dataset_conversion/Dataset220_KiTS2023.py
- AMOS22 task1/2:  Dataset218_Amos2022_task1.py / Dataset219_Amos2022_task2.py
- AutoPET-II:      Dataset221_AutoPETII_2023.py
- M&Ms:            Dataset114_MNMs.py
- EMIDEC:          Dataset115_EMIDEC.py
- Fluo-C3DH-A549-SIM: Dataset073_Fluo_C3DH_A549_SIM.py
- RoadSegmentation:   Dataset120_RoadSegmentation.py
- old nnU-Net v1 raw: convert_raw_dataset_from_old_nnunet_format.py

Counterpart of anatomask_tpu/dataset_conversion/convert_challenges.py, copied function for function.
"""
from __future__ import annotations

import csv
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import load_json, save_json


def _out_dirs(dataset_id: int, task_name: str, test: bool = True) -> Tuple[str, str, str, str]:
    out = os.path.join(require("raw"), f"Dataset{dataset_id:03d}_{task_name}")
    imagestr = os.path.join(out, "imagesTr")
    labelstr = os.path.join(out, "labelsTr")
    imagests = os.path.join(out, "imagesTs")
    os.makedirs(imagestr, exist_ok=True)
    os.makedirs(labelstr, exist_ok=True)
    if test:
        os.makedirs(imagests, exist_ok=True)
    return out, imagestr, labelstr, imagests


def convert_kits2023(kits_base_dir: str, dataset_id: int = 220) -> str:
    """case_XXXXX/imaging.nii.gz + segmentation.nii.gz -> region-based labels
    kidney=(1,2,3) masses=(2,3) tumor=2, regions_class_order (1,3,2)."""
    out, imagestr, labelstr, _ = _out_dirs(dataset_id, "KiTS2023", test=False)
    cases = sorted(d for d in os.listdir(kits_base_dir)
                   if d.startswith("case_") and os.path.isdir(os.path.join(kits_base_dir, d)))
    for tr in cases:
        shutil.copy(os.path.join(kits_base_dir, tr, "imaging.nii.gz"),
                    os.path.join(imagestr, f"{tr}_0000.nii.gz"))
        shutil.copy(os.path.join(kits_base_dir, tr, "segmentation.nii.gz"),
                    os.path.join(labelstr, f"{tr}.nii.gz"))
    generate_dataset_json(
        out, {0: "CT"},
        labels={"background": 0, "kidney": (1, 2, 3), "masses": (2, 3), "tumor": 2},
        regions_class_order=(1, 3, 2),
        num_training_cases=len(cases), file_ending=".nii.gz",
        dataset_name="KiTS2023", reference="none", release="prerelease",
        overwrite_image_reader_writer="NibabelIOWithReorient",
        description="KiTS2023")
    return out


def _amos_ids(entries: List[dict]) -> List[str]:
    return [e["image"].split("/")[-1][: -len(".nii.gz")] for e in entries]


def convert_amos_task1(amos_base_dir: str, dataset_id: int = 218) -> str:
    """CT-only subset (ids <= 410/409/500); validation merged into train."""
    out, imagestr, labelstr, imagests = _out_dirs(dataset_id, "AMOS2022_postChallenge_task1")
    src = load_json(os.path.join(amos_base_dir, "dataset.json"))
    n = 0
    for tr in _amos_ids(src["training"]):
        if int(tr.split("_")[-1]) <= 410:
            n += 1
            shutil.copy(os.path.join(amos_base_dir, "imagesTr", tr + ".nii.gz"),
                        os.path.join(imagestr, f"{tr}_0000.nii.gz"))
            shutil.copy(os.path.join(amos_base_dir, "labelsTr", tr + ".nii.gz"),
                        os.path.join(labelstr, f"{tr}.nii.gz"))
    for ts in _amos_ids(src.get("test", [])):
        if int(ts.split("_")[-1]) <= 500:
            shutil.copy(os.path.join(amos_base_dir, "imagesTs", ts + ".nii.gz"),
                        os.path.join(imagests, f"{ts}_0000.nii.gz"))
    for vl in _amos_ids(src.get("validation", [])):
        if int(vl.split("_")[-1]) <= 409:
            n += 1
            shutil.copy(os.path.join(amos_base_dir, "imagesVa", vl + ".nii.gz"),
                        os.path.join(imagestr, f"{vl}_0000.nii.gz"))
            shutil.copy(os.path.join(amos_base_dir, "labelsVa", vl + ".nii.gz"),
                        os.path.join(labelstr, f"{vl}.nii.gz"))
    generate_dataset_json(
        out, {0: "CT"}, labels={v: int(k) for k, v in src["labels"].items()},
        num_training_cases=n, file_ending=".nii.gz",
        dataset_name="AMOS2022_postChallenge_task1",
        reference="https://amos22.grand-challenge.org/",
        overwrite_image_reader_writer="NibabelIOWithReorient",
        description="post-challenge AMOS task1 (CT); validation merged into train")
    return out


def convert_amos_task2(amos_base_dir: str, dataset_id: int = 219) -> str:
    """CT+MRI, all cases; validation merged into train."""
    out, imagestr, labelstr, imagests = _out_dirs(dataset_id, "AMOS2022_postChallenge_task2")
    src = load_json(os.path.join(amos_base_dir, "dataset.json"))
    tr_ids = _amos_ids(src["training"])
    val_ids = _amos_ids(src.get("validation", []))
    for tr in tr_ids:
        shutil.copy(os.path.join(amos_base_dir, "imagesTr", tr + ".nii.gz"),
                    os.path.join(imagestr, f"{tr}_0000.nii.gz"))
        shutil.copy(os.path.join(amos_base_dir, "labelsTr", tr + ".nii.gz"),
                    os.path.join(labelstr, f"{tr}.nii.gz"))
    for ts in _amos_ids(src.get("test", [])):
        shutil.copy(os.path.join(amos_base_dir, "imagesTs", ts + ".nii.gz"),
                    os.path.join(imagests, f"{ts}_0000.nii.gz"))
    for vl in val_ids:
        shutil.copy(os.path.join(amos_base_dir, "imagesVa", vl + ".nii.gz"),
                    os.path.join(imagestr, f"{vl}_0000.nii.gz"))
        shutil.copy(os.path.join(amos_base_dir, "labelsVa", vl + ".nii.gz"),
                    os.path.join(labelstr, f"{vl}.nii.gz"))
    generate_dataset_json(
        out, {0: "either_CT_or_MR"},
        labels={v: int(k) for k, v in src["labels"].items()},
        num_training_cases=len(tr_ids) + len(val_ids), file_ending=".nii.gz",
        dataset_name="AMOS2022_postChallenge_task2",
        reference="https://amos22.grand-challenge.org/",
        overwrite_image_reader_writer="NibabelIOWithReorient",
        description="post-challenge AMOS task2 (CT+MRI); validation merged into train")
    return out


def convert_autopet(autopet_base_dir: str, dataset_id: int = 221) -> str:
    """PETCT_*/acquisition/{CTres,SUV,SEG}.nii.gz -> 2-channel cases + a
    patient-stratified 5-fold split in preprocessed/splits_final.json."""
    out, imagestr, labelstr, _ = _out_dirs(dataset_id, "AutoPETII_2023", test=False)
    patients = sorted(d for d in os.listdir(autopet_base_dir)
                      if d.startswith("PETCT") and os.path.isdir(os.path.join(autopet_base_dir, d)))
    identifiers = []
    for pat in patients:
        for pa in sorted(os.listdir(os.path.join(autopet_base_dir, pat))):
            src = os.path.join(autopet_base_dir, pat, pa)
            if not os.path.isdir(src):
                continue
            ident = f"{pat}_{pa}"
            identifiers.append(ident)
            shutil.copy(os.path.join(src, "CTres.nii.gz"),
                        os.path.join(imagestr, f"{ident}_0000.nii.gz"))
            shutil.copy(os.path.join(src, "SUV.nii.gz"),
                        os.path.join(imagestr, f"{ident}_0001.nii.gz"))
            shutil.copy(os.path.join(src, "SEG.nii.gz"),
                        os.path.join(labelstr, f"{ident}.nii.gz"))
    # channel 1 (SUV) intentionally named CT like the reference converter so
    # the normalization scheme matches its published recipe (:36)
    generate_dataset_json(
        out, {0: "CT", 1: "CT"}, labels={"background": 0, "tumor": 1},
        num_training_cases=len(identifiers), file_ending=".nii.gz",
        dataset_name="AutoPETII_2023",
        reference="https://autopet-ii.grand-challenge.org/",
        description="AutoPETII_2023")
    # patient-level 5-fold split (acquisitions of one patient never straddle folds)
    splits = []
    for fold in range(5):
        val_patients = patients[fold::5]
        splits.append({
            "train": [i for i in identifiers if not any(i.startswith(v) for v in val_patients)],
            "val": [i for i in identifiers if any(i.startswith(v) for v in val_patients)],
        })
    pp_out = os.path.join(require("preprocessed"), f"Dataset{dataset_id:03d}_AutoPETII_2023")
    os.makedirs(pp_out, exist_ok=True)
    save_json(splits, os.path.join(pp_out, "splits_final.json"), sort_keys=False)
    return out


def _read_mnms_csv(csv_file: str) -> Dict[str, dict]:
    info = {}
    with open(csv_file) as f:
        reader = csv.reader(f)
        headers = next(reader)
        pi = headers.index("External code")
        ed = headers.index("ED")
        es = headers.index("ES")
        vd = headers.index("Vendor")
        for row in reader:
            info[row[pi]] = {"ed": int(row[ed]), "es": int(row[es]), "vendor": row[vd]}
    return info


def convert_mnms(src_data_folder: str, csv_file_name: str, dataset_id: int = 114) -> str:
    """M&Ms: extract the ED and ES frames from each 4D short-axis cine volume
    (the annotated time points) as independent 3D training cases."""
    from anatomask_torch.imageio.nifti import read_nifti, write_nifti
    out, imagestr, labelstr, imagests = _out_dirs(dataset_id, "MNMs")
    info = _read_mnms_csv(os.path.join(src_data_folder, csv_file_name))

    def save_phases(patient_dir: str, name: str, img_out: str, lab_out: Optional[str]):
        data, h = read_nifti(os.path.join(patient_dir, f"{name}_sa.nii.gz"))
        frames = (info[name]["ed"], info[name]["es"])
        for fr in frames:
            vol = np.ascontiguousarray(data[..., fr]) if data.ndim == 4 else data
            write_nifti(os.path.join(img_out, f"{name}_frame{fr:02d}_0000.nii.gz"),
                        vol, header=h)
        if lab_out is not None:
            seg, hs = read_nifti(os.path.join(patient_dir, f"{name}_sa_gt.nii.gz"))
            for fr in frames:
                v = np.ascontiguousarray(seg[..., fr]) if seg.ndim == 4 else seg
                write_nifti(os.path.join(lab_out, f"{name}_frame{fr:02d}.nii.gz"),
                            v.astype(np.uint8), header=hs)

    train_dir = os.path.join(src_data_folder, "Training", "Labeled")
    patients_train = sorted(d for d in os.listdir(train_dir)
                            if os.path.isdir(os.path.join(train_dir, d)))
    for p in patients_train:
        save_phases(os.path.join(train_dir, p), p, imagestr, labelstr)
    test_dir = os.path.join(src_data_folder, "Testing")
    if os.path.isdir(test_dir):
        for p in sorted(os.listdir(test_dir)):
            if os.path.isdir(os.path.join(test_dir, p)):
                save_phases(os.path.join(test_dir, p), p, imagests, None)

    generate_dataset_json(
        out, {0: "cineMRI"},
        labels={"background": 0, "LVBP": 1, "LVM": 2, "RV": 3},
        num_training_cases=len(patients_train) * 2, file_ending=".nii.gz",
        dataset_name="MNMs")
    return out


def create_mnms_custom_splits(src_data_folder: str, csv_file: str, dataset_id: int = 114,
                              num_val_patients: int = 25, seed: int = 1234):
    """Append the vendor-stratified custom splits (train on A / B / A+B mixes,
    validate on A, B, A+B; reference Dataset114_MNMs.create_custom_splits)."""
    name = f"Dataset{dataset_id:03d}_MNMs"
    splits_file = os.path.join(require("preprocessed"), name, "splits_final.json")
    splits = load_json(splits_file)
    train_dir = os.path.join(src_data_folder, "Training", "Labeled")
    patients_train = {d for d in os.listdir(train_dir)
                      if os.path.isdir(os.path.join(train_dir, d))}
    info = {p: d for p, d in _read_mnms_csv(os.path.join(src_data_folder, csv_file)).items()
            if p in patients_train}
    rng = np.random.RandomState(seed)

    def vendor_split(patients: List[str]):
        patients = list(patients)
        rng.shuffle(patients)
        return patients[:-num_val_patients], patients[-num_val_patients:]

    def frames(patients: List[str]):
        return [f"{p}_frame{info[p][fr]:02d}" for p in patients for fr in ("es", "ed")]

    pa = [p for p, d in info.items() if d["vendor"] == "A"]
    pb = [p for p, d in info.items() if d["vendor"] == "B"]
    tr_a, val_a = vendor_split(pa)
    tr_b, val_b = vendor_split(pb)
    tr_a, tr_b = frames(tr_a), frames(tr_b)
    val_a, val_b = frames(val_a), frames(val_b)
    mixes = [tr_a, tr_b,
             tr_a[:len(tr_a) // 2] + tr_b[:len(tr_b) // 2],
             tr_a[len(tr_a) // 2:] + tr_b[len(tr_b) // 2:]]
    for train_set in mixes:
        splits.append({"train": train_set, "val": val_a})
        splits.append({"train": train_set, "val": val_b})
        splits.append({"train": train_set, "val": val_a + val_b})
    save_json(splits, splits_file, sort_keys=False)
    return splits


def convert_emidec(src_data_dir: str, src_test_dir: str, dataset_id: int = 115) -> str:
    """EMIDEC cardiac MRI: CaseXXX/Images + /Contours -> images/labels."""
    out, imagestr, labelstr, imagests = _out_dirs(dataset_id, "EMIDEC")
    patients = sorted(d for d in os.listdir(src_data_dir)
                      if os.path.isdir(os.path.join(src_data_dir, d)))
    for p in patients:
        shutil.copy(os.path.join(src_data_dir, p, "Images", f"{p}.nii.gz"),
                    os.path.join(imagestr, f"{p}_0000.nii.gz"))
        shutil.copy(os.path.join(src_data_dir, p, "Contours", f"{p}.nii.gz"),
                    os.path.join(labelstr, f"{p}.nii.gz"))
    if src_test_dir and os.path.isdir(src_test_dir):
        for p in sorted(os.listdir(src_test_dir)):
            f = os.path.join(src_test_dir, p, "Images", f"{p}.nii.gz")
            if os.path.isfile(f):
                shutil.copy(f, os.path.join(imagests, f"{p}_0000.nii.gz"))
    generate_dataset_json(
        out, {0: "cineMRI"},
        labels={"background": 0, "cavity": 1, "normal_myocardium": 2,
                "myocardial_infarction": 3, "no_reflow": 4},
        num_training_cases=len(patients), file_ending=".nii.gz",
        dataset_name="EMIDEC")
    return out


def convert_fluo_c3dh_a549_sim(train_source: str, test_source: Optional[str] = None,
                               dataset_id: int = 73) -> str:
    """Cell-tracking-challenge TIFF dataset: copy .tif volumes + per-case
    spacing sidecar JSONs; fixed 2-fold split by sequence."""
    name = "Fluo_C3DH_A549_SIM"
    out, imagestr, labelstr, imagests = _out_dirs(dataset_id, name)
    spacing = (1, 0.126, 0.126)
    n = 0
    for seq in ("01", "02"):
        images_dir = os.path.join(train_source, seq)
        seg_dir = os.path.join(train_source, seq + "_GT", "SEG")
        if not os.path.isdir(images_dir):
            continue
        images = sorted(f for f in os.listdir(images_dir) if f.endswith(".tif"))
        segs = sorted(f for f in os.listdir(seg_dir) if f.endswith(".tif"))
        for i, (im, se) in enumerate(zip(images, segs)):
            tgt = f"{seq}_image_{i:03d}"
            shutil.copy(os.path.join(images_dir, im), os.path.join(imagestr, tgt + "_0000.tif"))
            save_json({"spacing": list(spacing)}, os.path.join(imagestr, tgt + ".json"))
            shutil.copy(os.path.join(seg_dir, se), os.path.join(labelstr, tgt + ".tif"))
            save_json({"spacing": list(spacing)}, os.path.join(labelstr, tgt + ".json"))
            n += 1
    if test_source:
        for seq in ("01", "02"):
            images_dir = os.path.join(test_source, seq)
            if not os.path.isdir(images_dir):
                continue
            for i, im in enumerate(sorted(f for f in os.listdir(images_dir) if f.endswith(".tif"))):
                tgt = f"{seq}_image_{i:03d}"
                shutil.copy(os.path.join(images_dir, im), os.path.join(imagests, tgt + "_0000.tif"))
                save_json({"spacing": list(spacing)}, os.path.join(imagests, tgt + ".json"))
    generate_dataset_json(
        out, {0: "fluorescence_microscopy"}, {"background": 0, "cell": 1},
        n, ".tif", dataset_name=f"Dataset{dataset_id:03d}_{name}")
    # 2-fold split by acquisition sequence
    caseids = sorted(f[:-4] for f in os.listdir(labelstr) if f.endswith(".tif"))
    splits = [
        {"train": [c for c in caseids if c.startswith("01_")],
         "val": [c for c in caseids if c.startswith("02_")]},
        {"train": [c for c in caseids if c.startswith("02_")],
         "val": [c for c in caseids if c.startswith("01_")]},
    ]
    pp_out = os.path.join(require("preprocessed"), f"Dataset{dataset_id:03d}_{name}")
    os.makedirs(pp_out, exist_ok=True)
    save_json(splits, os.path.join(pp_out, "splits_final.json"))
    return out


def _filter_small_components(mask: np.ndarray, min_size: int) -> np.ndarray:
    from scipy import ndimage
    lab, n = ndimage.label(mask)
    if n == 0:
        return mask
    sizes = ndimage.sum_labels(np.ones_like(lab), lab, index=np.arange(1, n + 1))
    keep = np.zeros(n + 1, bool)
    keep[1:] = sizes > min_size
    return keep[lab]


def convert_road_segmentation(source: str, dataset_id: int = 120,
                              min_component_size: int = 50) -> str:
    """Massachusetts road segmentation (2D PNG): seg 255->1; pixels where the
    image is pure white (no information) get their road label removed
    (connected components > min_size, hole-filled)."""
    from PIL import Image
    from scipy.ndimage import binary_fill_holes
    name = "RoadSegmentation"
    out, imagestr, labelstr, imagests = _out_dirs(dataset_id, name)
    labelsts = os.path.join(out, "labelsTs")
    os.makedirs(labelsts, exist_ok=True)

    def one(in_img, in_seg, out_img, out_seg):
        seg = np.asarray(Image.open(in_seg)).copy()
        seg[seg == 255] = 1
        img = np.asarray(Image.open(in_img), dtype=np.int32)
        white = img.sum(2) == 3 * 255
        white = _filter_small_components(white, min_component_size)
        white = binary_fill_holes(white)
        seg[white] = 0
        Image.fromarray(seg.astype(np.uint8)).save(out_seg)
        shutil.copy(in_img, out_img)

    n = 0
    for sub, img_out, seg_out in (("training", imagestr, labelstr),
                                  ("testing", imagests, labelsts)):
        base = os.path.join(source, sub)
        if not os.path.isdir(base):
            continue
        for v in sorted(os.listdir(os.path.join(base, "output"))):
            if not v.endswith("png"):
                continue
            one(os.path.join(base, "input", v), os.path.join(base, "output", v),
                os.path.join(img_out, v[:-4] + "_0000.png"),
                os.path.join(seg_out, v))
            if sub == "training":
                n += 1
    generate_dataset_json(
        out, {0: "R", 1: "G", 2: "B"}, {"background": 0, "road": 1},
        n, ".png", dataset_name=name)
    return out


def convert_old_nnunet_dataset(source_folder: str, target_dataset_name: str) -> str:
    """nnU-Net v1 TaskXXX_YYY raw folder -> v2/ATK DatasetXXX_YYY raw folder
    (copy trees, rewrite dataset.json: modality->channel_names, labels inverted,
    drop the training/test file lists)."""
    target = os.path.join(require("raw"), target_dataset_name)
    if os.path.isdir(target):
        raise RuntimeError(
            f"Target dataset {target_dataset_name} already exists at {target}; "
            f"delete it manually to proceed.")
    os.makedirs(target)
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs", "imagesVal", "labelsVal"):
        src = os.path.join(source_folder, sub)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(target, sub))
    dj = load_json(os.path.join(source_folder, "dataset.json"))
    for k in ("tensorImageSize", "numTest", "training", "test"):
        dj.pop(k, None)
    dj["channel_names"] = dict(dj.pop("modality"))
    dj["labels"] = {v: int(k) for k, v in dj["labels"].items()}
    dj["file_ending"] = ".nii.gz"
    save_json(dj, os.path.join(target, "dataset.json"), sort_keys=False)
    return target

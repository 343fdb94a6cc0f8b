"""anatomask_torch's end of the workflow against anatomask_tpu's on the same
seeded inputs: connected-component removal, determine_postprocessing and
apply_postprocessing_to_folder (the same postprocessing.json, the same
segmentations), probability averaging and ensemble_folders,
accumulate_cv_results and find_best_configuration over fabricated results
trees (summary.json, npz probabilities, two configurations and their
ensemble), and model zips that install across the two packages. Both sides
are host numpy: JSON must be equal, arrays bit-equal (NIfTI files are
compared by their arrays and affines, since gzip stamps the time)."""
import json
import os
import shutil
import zipfile

import numpy as np
import pytest

from anatomask_tpu.ensembling import ensemble as jens
from anatomask_tpu.evaluation import find_best_configuration as jfind
from anatomask_tpu.postprocessing import components as jpp
from anatomask_tpu.utils import model_sharing as jshare
from anatomask_torch.ensembling import ensemble as tens
from anatomask_torch.evaluation import find_best_configuration as tfind
from anatomask_torch.imageio.nifti import NiftiIO, read_nifti, write_nifti
from anatomask_torch.postprocessing import components as tpp
from anatomask_torch.preprocessing.preprocessor import save_properties
from anatomask_torch.utils import model_sharing as tshare

DATASET = "Dataset964_PostSynth"
SHAPE = (12, 14, 16)  # array (z, y, x)
LABELS = {"background": 0, "kidney": 1, "tumor": 2}
DATASET_JSON = {"channel_names": {"0": "CT"}, "labels": LABELS, "numTraining": 4,
                "file_ending": ".nii.gz"}
PLANS = {"dataset_name": DATASET, "plans_name": "ATKPlans", "image_reader_writer": "NiftiIO",
         "configurations": {}}
CASES = ("case_000", "case_001", "case_002", "case_003")


def _env(tmp_path, monkeypatch, name):
    dirs = {w: str(tmp_path / name / w) for w in ("raw", "preprocessed", "results")}
    for w, d in dirs.items():
        os.makedirs(d)
        monkeypatch.setenv(f"ATK_{w}", d)
    return dirs


def _blobs(rs, n_extra):
    """Labels 1 and 2 as balls, plus n_extra small stray cubes of label 1."""
    seg = np.zeros(SHAPE, np.uint8)
    zz, yy, xx = np.meshgrid(*[np.arange(s) for s in SHAPE], indexing="ij")
    for lab in (1, 2):
        c = [rs.randint(3, s - 3) for s in SHAPE]
        seg[(zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 < 9] = lab
    for _ in range(n_extra):
        z, y, x = (rs.randint(0, s - 1) for s in SHAPE)
        seg[z:z + 1, y:y + 2, x:x + 1] = 1
    return seg


def _write_seg(path, seg):
    write_nifti(path, seg.transpose(2, 1, 0), spacing_xyz=(1.0, 1.0, 1.5))


def _write_json(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _assert_same_niftis(a_folder, b_folder):
    names = sorted(f for f in os.listdir(a_folder) if f.endswith(".nii.gz"))
    assert names and names == sorted(f for f in os.listdir(b_folder) if f.endswith(".nii.gz"))
    for n in names:
        a, ha = read_nifti(os.path.join(a_folder, n))
        b, hb = read_nifti(os.path.join(b_folder, n))
        assert a.dtype == b.dtype, n
        np.testing.assert_array_equal(a, b, err_msg=n)
        np.testing.assert_array_equal(ha["affine"], hb["affine"], err_msg=n)


@pytest.mark.parametrize("labels_or_regions", [1, [1, 2], [(1, 2)], [2, (1, 2)]],
                         ids=["label", "labels", "region", "label_and_region"])
def test_component_removal_matches_jax(labels_or_regions):
    rs = np.random.RandomState(0)
    seg = _blobs(rs, 6)
    j = jpp.remove_all_but_largest_component_from_segmentation(seg, labels_or_regions)
    t = tpp.remove_all_but_largest_component_from_segmentation(seg, labels_or_regions)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)
    assert (t != seg).any()


def _pp_folders(root):
    """Reference and predicted segmentations: predictions with stray label-1
    cubes (removing them helps) and, in one case, a reference with two
    tumour components."""
    rs = np.random.RandomState(1)
    ref, pred = os.path.join(root, "ref"), os.path.join(root, "pred")
    os.makedirs(ref)
    os.makedirs(pred)
    for i, case in enumerate(CASES):
        gt = _blobs(rs, 0)
        if i == 0:
            gt[0:2, 0:2, 0:2] = 2
        p = gt.copy()
        p[_blobs(rs, 4) == 1] = 1
        _write_seg(os.path.join(ref, case + ".nii.gz"), gt)
        _write_seg(os.path.join(pred, case + ".nii.gz"), p)
    return ref, pred


def test_determine_and_apply_postprocessing_match_jax(tmp_path):
    ref, pred = _pp_folders(str(tmp_path))
    runs = {}
    for name, mod in (("jax", jpp), ("torch", tpp)):
        folder = os.path.join(str(tmp_path), f"pred_{name}")
        shutil.copytree(pred, folder)
        fns, metrics = mod.determine_postprocessing(folder, ref, NiftiIO(), ".nii.gz", [1, 2],
                                                    num_processes=2)
        applied = os.path.join(str(tmp_path), f"applied_{name}")
        mod.apply_postprocessing_to_folder(
            pred, applied, mod.load_postprocessing_description(
                os.path.join(folder, "postprocessing.json")), NiftiIO(), ".nii.gz", 2)
        runs[name] = (folder, fns, metrics, applied)
    (jf, jfns, jm, ja), (tf, tfns, tm, ta) = runs["jax"], runs["torch"]
    assert tfns == jfns and jfns  # at least one step kept
    assert (tm["mean"], tm["foreground_mean"]) == (jm["mean"], jm["foreground_mean"])
    assert _read(os.path.join(tf, "postprocessing.json")) == _read(
        os.path.join(jf, "postprocessing.json"))
    _assert_same_niftis(jf + "_postprocessed", tf + "_postprocessed")
    _assert_same_niftis(ja, ta)


def _probabilities(rs):
    p = rs.rand(len(LABELS), *SHAPE).astype(np.float32)
    return p / p.sum(0, keepdims=True)


def _prediction_folder(folder, rs, cases=CASES):
    """A prediction folder as predict_from_files --save_probabilities leaves
    it: dataset.json, plans.json, a segmentation, probabilities and
    properties a case."""
    os.makedirs(folder, exist_ok=True)
    _write_json(DATASET_JSON, os.path.join(folder, "dataset.json"))
    _write_json(PLANS, os.path.join(folder, "plans.json"))
    for case in cases:
        probs = _probabilities(rs)
        base = os.path.join(folder, case)
        _write_seg(base + ".nii.gz", probs.argmax(0).astype(np.uint8))
        _, props = NiftiIO().read_images([base + ".nii.gz"])
        save_properties(props, base)
        np.savez_compressed(base + ".npz", probabilities=probs)


def test_average_probabilities_and_ensemble_folders_match_jax(tmp_path):
    rs = np.random.RandomState(2)
    folders = [str(tmp_path / f"pred{i}") for i in range(3)]
    for f in folders:
        _prediction_folder(f, rs)
    files = [os.path.join(f, "case_001.npz") for f in folders]
    j = jens.average_probabilities(files)
    t = tens.average_probabilities(files)
    assert t.dtype == j.dtype
    np.testing.assert_array_equal(t, j)
    for save_npz in (False, True):
        out_j, out_t = str(tmp_path / f"ens_jax_{save_npz}"), str(tmp_path / f"ens_t_{save_npz}")
        jens.ensemble_folders(folders, out_j, save_npz, 1)
        tens.ensemble_folders(folders, out_t, save_npz, 2)
        _assert_same_niftis(out_j, out_t)
        npz = sorted(f for f in os.listdir(out_t) if f.endswith(".npz"))
        assert npz == sorted(f for f in os.listdir(out_j) if f.endswith(".npz"))
        assert len(npz) == (len(CASES) if save_npz else 0)
        for n in npz:
            with np.load(os.path.join(out_j, n)) as zj, np.load(os.path.join(out_t, n)) as zt:
                np.testing.assert_array_equal(zt["probabilities"], zj["probabilities"])


CONFIGS = ("3d_fullres", "2d")
TRAINER = "ATKTrainer_1epoch"


def _results_tree(dirs):
    """Two configurations, two folds each, with validation segmentations and
    probabilities, and the ground truth in gt_segmentations."""
    rs = np.random.RandomState(3)
    gt = os.path.join(dirs["preprocessed"], DATASET, "gt_segmentations")
    os.makedirs(gt)
    for case in CASES:
        _write_seg(os.path.join(gt, case + ".nii.gz"), _blobs(rs, 0))
    for config in CONFIGS:
        model = os.path.join(dirs["results"], DATASET, f"{TRAINER}__ATKPlans__{config}")
        os.makedirs(model)
        _write_json(DATASET_JSON, os.path.join(model, "dataset.json"))
        _write_json(PLANS, os.path.join(model, "plans.json"))
        for fold, cases in enumerate((CASES[:2], CASES[2:])):
            vdir = os.path.join(model, f"fold_{fold}", "validation")
            _prediction_folder(vdir, rs, cases)
            for f in ("dataset.json", "plans.json"):
                os.remove(os.path.join(vdir, f))
            _write_json({"foreground_mean": {"Dice": 0.5}}, os.path.join(vdir, "summary.json"))


def _relative(obj, root):
    """obj with root's path replaced by '<root>' in every string."""
    return json.loads(json.dumps(obj).replace(root, "<root>"))


def test_accumulate_and_find_best_configuration_match_jax(tmp_path, monkeypatch):
    outs = {}
    for name, mod in (("jax", jfind), ("torch", tfind)):
        dirs = _env(tmp_path, monkeypatch, name)
        _results_tree(dirs)
        model = mod.folder_for_model(DATASET, TRAINER, "ATKPlans", "3d_fullres")
        merged = model + "_crossval_results"
        m = mod.accumulate_cv_results(model, merged, [0, 1], num_processes=2)
        info = mod.find_best_configuration(DATASET, list(CONFIGS), [TRAINER], ["ATKPlans"],
                                           [0, 1], num_processes=2)
        root = str(tmp_path / name)
        outs[name] = (root, _relative(m, root), _relative(info, root))
    (jroot, jm, jinfo), (troot, tm, tinfo) = outs["jax"], outs["torch"]
    assert tm == jm
    assert tinfo == jinfo
    assert any(c["ensemble"] for c in tinfo["considered"])
    results = os.path.join("results", DATASET)
    for rel in ("inference_information.json",):
        assert _relative(_read(os.path.join(troot, results, rel)), troot) == _relative(
            _read(os.path.join(jroot, results, rel)), jroot)
    best = tinfo["best_model_or_ensemble"]
    merged = [c["merged_folder"].replace("<root>", "") for c in tinfo["considered"]
              if c["configuration"] == best["configuration"]][0]
    assert _read(troot + merged + "/postprocessing.json") == _read(
        jroot + merged + "/postprocessing.json")
    assert _relative(_read(troot + merged + "/summary.json"), troot) == _relative(
        _read(jroot + merged + "/summary.json"), jroot)
    for c in tinfo["considered"]:
        folder = c["merged_folder"].replace("<root>", "")
        _assert_same_niftis(jroot + folder, troot + folder)


def _model_tree(results):
    model = os.path.join(results, DATASET, f"{TRAINER}__ATKPlans__3d_fullres")
    for fold in (0, 1):
        os.makedirs(os.path.join(model, f"fold_{fold}"))
        np.savez(os.path.join(model, f"fold_{fold}", "checkpoint_final.npz"),
                 w=np.arange(fold + 3, dtype=np.float32))
        _write_json({"fold": fold}, os.path.join(model, f"fold_{fold}", "debug.json"))
    for f, obj in (("plans.json", PLANS), ("dataset.json", DATASET_JSON),
                   ("postprocessing.json", {"pp_fns_args": []})):
        _write_json(obj, os.path.join(model, f))


def _files(root):
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = fh.read()
    return out


def test_model_zips_install_across_packages(tmp_path, monkeypatch):
    dirs = _env(tmp_path, monkeypatch, "source")
    _model_tree(dirs["results"])
    zips = {}
    for name, mod in (("jax", jshare), ("torch", tshare)):
        zips[name] = str(tmp_path / f"{name}.zip")
        mod.export_pretrained_model(DATASET, zips[name], TRAINER, "ATKPlans", ["3d_fullres"],
                                    [0, 1])
    with zipfile.ZipFile(zips["jax"]) as zj, zipfile.ZipFile(zips["torch"]) as zt:
        assert sorted(zt.namelist()) == sorted(zj.namelist())
    source = _files(dirs["results"])
    for zip_of, installer in (("torch", jshare), ("jax", tshare)):
        target = _env(tmp_path, monkeypatch, f"install_{zip_of}")["results"]
        installer.install_model_from_zip_file(zips[zip_of])
        assert _files(target) == source

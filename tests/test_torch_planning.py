"""anatomask_torch's planning against anatomask_tpu's on the same raw
datasets (tests/synthetic.py, seeded): the topology, the dataset
fingerprint, the experiment planner's whole plans file (with an overwritten
target spacing, an anisotropic dataset, a fingerprint large enough for
3d_lowres and the cascade, the residual-encoder planner, memory targets 8
and 40), the integrity check's messages, the plans transfer, and
plan_and_preprocess's preprocessed files. Both sides are host numpy:
JSON and written files must be equal, arrays bit-equal."""
import json
import os
import shutil

import numpy as np
import pytest

from anatomask_tpu.planning import fingerprint as jfp
from anatomask_tpu.planning import planner as jplanner
from anatomask_tpu.planning import topology as jtopo
from anatomask_tpu.planning.move_plans import move_plans_between_datasets as jmove
from anatomask_tpu.planning.verify_integrity import verify_dataset_integrity as jverify
from anatomask_torch.planning import fingerprint as tfp
from anatomask_torch.planning import planner as tplanner
from anatomask_torch.planning import topology as ttopo
from anatomask_torch.planning.move_plans import move_plans_between_datasets as tmove
from anatomask_torch.planning.verify_integrity import verify_dataset_integrity as tverify

from synthetic import make_synthetic_dataset

DATASET = "Dataset961_PlanSynth"


def _env(tmp_path, monkeypatch):
    dirs = {w: str(tmp_path / w) for w in ("raw", "preprocessed", "results")}
    for w, d in dirs.items():
        os.makedirs(d)
        monkeypatch.setenv(f"ATK_{w}", d)
    return dirs


def _read(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("spacing,patch", [
    ((1.0, 1.0, 1.0), (128, 128, 128)), ((3.0, 0.8, 0.8), (40, 224, 192)),
    ((1.5, 0.8, 0.8), (160, 192, 192)), ((5.0, 1.0, 1.0), (20, 256, 256)),
    ((0.7, 0.7), (512, 384)), ((2.0, 1.0, 0.5), (57, 91, 203))])
def test_topology_matches_jax(spacing, patch):
    j = jtopo.get_pool_and_conv_props(spacing, patch, 4, 999999)
    t = ttopo.get_pool_and_conv_props(spacing, patch, 4, 999999)
    assert j[:3] == t[:3]
    np.testing.assert_array_equal(j[3], t[3])
    np.testing.assert_array_equal(j[4], t[4])
    np.testing.assert_array_equal(jtopo.pad_shape(patch, 16), ttopo.pad_shape(patch, 16))


@pytest.mark.parametrize("num_processes", [1, 2])
def test_fingerprint_matches_jax(tmp_path, monkeypatch, num_processes):
    dirs = _env(tmp_path, monkeypatch)
    make_synthetic_dataset(dirs["raw"], DATASET, num_cases=4, shape=(14, 16, 13), seed=3)
    out = os.path.join(dirs["preprocessed"], DATASET, "dataset_fingerprint.json")
    for extractor in (jfp.DatasetFingerprintExtractor(DATASET, 1),
                      tfp.DatasetFingerprintExtractor(DATASET, num_processes)):
        # 1e5 foreground samples over the dataset, not 1e8: the same draws, cheaper
        extractor.num_foreground_voxels_for_intensitystats = 1e5
        extractor.run(overwrite_existing=True)
        if isinstance(extractor, jfp.DatasetFingerprintExtractor):
            j = _read(out)
            os.remove(out)
    assert _read(out) == j


def _plans_of(planner_cls, dataset, plans_name, **kw):
    planner = planner_cls(dataset, plans_name=plans_name, **kw)
    path = os.path.join(os.environ["ATK_preprocessed"], dataset, plans_name + ".json")
    if os.path.isfile(path):
        os.remove(path)
    planner.plan_experiment()
    return _read(path)


def _fingerprint(spacings, shapes, relative_size):
    fg = {"mean": 80.0, "median": 75.0, "std": 30.0, "min": -20.0, "max": 400.0,
          "percentile_99_5": 300.0, "percentile_00_5": 0.0}
    return {"spacings": spacings, "shapes_after_crop": shapes,
            "foreground_intensity_properties_per_channel": {"0": fg, "1": fg},
            "median_relative_size_after_cropping": relative_size}


# name: (planner keywords, fingerprint, planner class)
PLANNER_CASES = {
    "default": ({}, _fingerprint([[1.0, 1.0, 1.0]] * 3, [[120, 160, 150], [110, 150, 160],
                                                           [130, 170, 140]], 1.0),
                "ExperimentPlanner"),
    "target_spacing": ({"overwrite_target_spacing": [2.0, 1.5, 1.25]},
                       _fingerprint([[1.0, 1.0, 1.0]] * 3, [[120, 160, 150]] * 3, 0.7),
                       "ExperimentPlanner"),
    "anisotropic": ({}, _fingerprint([[4.0, 0.9, 0.9], [5.0, 0.8, 0.8], [4.5, 0.85, 0.85]],
                                     [[40, 300, 300], [30, 320, 310], [36, 290, 300]], 0.6),
                    "ExperimentPlanner"),
    "lowres": ({}, _fingerprint([[2.5, 0.78, 0.78], [3.0, 0.7, 0.7], [1.25, 0.9, 0.9]],
                                [[180, 512, 512], [150, 490, 470], [420, 512, 512]], 1.0),
               "ExperimentPlanner"),
    "resenc": ({}, _fingerprint([[1.5, 0.8, 0.8]] * 3, [[160, 192, 192]] * 3, 1.0),
               "ResEncUNetPlanner"),
    "memory_40": ({"memory_target_gb": 40.0},
                  _fingerprint([[1.5, 0.8, 0.8]] * 3, [[300, 400, 400]] * 3, 1.0),
                  "ExperimentPlanner"),
    "memory_8_resenc_lowres": ({"memory_target_gb": 8.0},
                               _fingerprint([[1.0, 0.7, 0.7]] * 3, [[400, 512, 512]] * 3, 0.9),
                               "ResEncUNetPlanner"),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_matches_jax(tmp_path, monkeypatch, case):
    from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
    kw, fingerprint, cls = PLANNER_CASES[case]
    dirs = _env(tmp_path, monkeypatch)
    raw = os.path.join(dirs["raw"], DATASET)
    os.makedirs(os.path.join(raw, "imagesTr"))
    open(os.path.join(raw, "imagesTr", "case_000_0000.nii.gz"), "w").close()
    generate_dataset_json(raw, {0: "CT", 1: "T2"}, {"background": 0, "kidney": 1, "tumor": 2},
                          len(fingerprint["spacings"]), ".nii.gz")
    os.makedirs(os.path.join(dirs["preprocessed"], DATASET))
    with open(os.path.join(dirs["preprocessed"], DATASET, "dataset_fingerprint.json"), "w") as f:
        json.dump(fingerprint, f)
    j = _plans_of(getattr(jplanner, cls), DATASET, "Plans", **kw)
    t = _plans_of(getattr(tplanner, cls), DATASET, "Plans", **kw)
    assert t == j
    if case == "lowres":
        assert {"3d_lowres", "3d_cascade_fullres"} <= set(t["configurations"])


def test_verify_integrity_matches_jax(tmp_path, monkeypatch, capsys):
    dirs = _env(tmp_path, monkeypatch)
    good, _ = make_synthetic_dataset(dirs["raw"], DATASET, num_cases=3, shape=(13, 14, 15))
    assert tverify(good) == jverify(good) == []
    out = capsys.readouterr().out
    assert out.count("Dataset OK") == 2

    from anatomask_tpu.imageio.nifti import write_nifti
    bad, _ = make_synthetic_dataset(dirs["raw"], "Dataset962_Bad", num_cases=3,
                                    shape=(13, 14, 15))
    seg = np.zeros((15, 14, 13), np.uint8)
    seg[2:4, 2:4, 2:4] = 7  # an undeclared label
    write_nifti(os.path.join(bad, "labelsTr", "case_000.nii.gz"), seg)
    write_nifti(os.path.join(bad, "labelsTr", "case_001.nii.gz"),
                np.zeros((15, 14, 12), np.uint8))  # a shape that is not the image's
    os.remove(os.path.join(bad, "labelsTr", "case_002.nii.gz"))
    j = jverify(bad)
    j_out = capsys.readouterr().out
    t = tverify(bad)
    assert t == j and len(t) == 3
    assert capsys.readouterr().out == j_out


def test_move_plans_matches_jax(tmp_path, monkeypatch):
    dirs = _env(tmp_path, monkeypatch)
    make_synthetic_dataset(dirs["raw"], DATASET, num_cases=3, shape=(14, 16, 13))
    make_synthetic_dataset(dirs["raw"], "Dataset963_Target", num_cases=2, shape=(13, 13, 13))
    extractor = tfp.DatasetFingerprintExtractor(DATASET, 1)
    extractor.num_foreground_voxels_for_intensitystats = 1e5
    extractor.run()
    tplanner.ExperimentPlanner(DATASET).plan_experiment()
    for sp, tp in (("ATKPlans", None), ("ATKPlans", "MovedPlans")):
        out = jmove(DATASET, 963, sp, tp)
        j = _read(out)
        os.remove(out)
        assert tmove(DATASET, 963, sp, tp) == out
        assert _read(out) == j


@pytest.mark.parametrize("name", ["Dataset009_Spleen", "Dataset961_PlanSynth", "Task09_Spleen"])
def test_dataset_name_to_id_matches_jax(name):
    from anatomask_tpu.utils.helpers import convert_dataset_name_to_id as jconvert
    from anatomask_torch.utils.helpers import convert_dataset_name_to_id as tconvert
    try:
        want = jconvert(name)
    except ValueError:
        with pytest.raises(ValueError):
            tconvert(name)
    else:
        assert tconvert(name) == want


def _tree(folder):
    return sorted(os.path.relpath(os.path.join(r, f), folder)
                  for r, _, fs in os.walk(folder) for f in fs)


def test_plan_and_preprocess_matches_jax(tmp_path, monkeypatch):
    dirs = _env(tmp_path, monkeypatch)
    make_synthetic_dataset(dirs["raw"], DATASET, num_cases=2, shape=(14, 16, 13),
                           spacing=(1.5, 1.0, 1.0), seed=7)
    pp = os.path.join(dirs["preprocessed"], DATASET)
    # both read one fingerprint of 1e5 foreground samples (overwrite=False
    # keeps it), so that the test pays for no 1e8-sample draw
    extractor = tfp.DatasetFingerprintExtractor(DATASET, 1)
    extractor.num_foreground_voxels_for_intensitystats = 1e5
    fingerprint = extractor.run()
    jplanner.plan_and_preprocess(DATASET, ("3d_fullres",), num_processes=1)
    jax_pp = str(tmp_path / "jax_pp")
    shutil.move(pp, jax_pp)
    os.makedirs(pp)
    shutil.copy(os.path.join(jax_pp, "dataset_fingerprint.json"), pp)
    tplanner.plan_and_preprocess(DATASET, ("3d_fullres",), num_processes=1)
    assert _read(os.path.join(pp, "dataset_fingerprint.json")) == fingerprint
    assert _tree(pp) == _tree(jax_pp)
    for rel in _tree(pp):
        a, b = os.path.join(pp, rel), os.path.join(jax_pp, rel)
        if rel.endswith(".json"):
            assert _read(a) == _read(b), rel
        elif rel.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype, (rel, k)
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{rel}:{k}")
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel

"""The port's last host modules against the JAX package's on inputs the test
writes itself: every dataset converter (`dataset_conversion/`) of both
packages into two raw trees, which must hold the same files, the same
dataset.json and split files, and the same images (arrays and headers);
`utils/batch_running.py` and `utils/collate.py`; the overlay PNGs where
matplotlib is present; and the argument parsers of the three new entries
(`atk_torch_convert_msd`, `atk_torch_convert_challenge` with every
subcommand, `atk_torch_plot_overlay_pngs`).

One departure is by design: `batch_running` writes the port's own entry,
`atk_torch_train`, where JAX's writes `atk_train`."""
import argparse
import importlib
import json
import os

import numpy as np
import pytest
from PIL import Image

from anatomask_tpu import paths as jpaths
from anatomask_torch import cli
from anatomask_torch.imageio.nifti import read_nifti, write_nifti

JAX, PORT = "anatomask_tpu", "anatomask_torch"


@pytest.fixture(autouse=True)
def _restore_jax_paths(monkeypatch):
    """The JAX package caches the ATK_* folders: read them again once the
    test's environment is undone."""
    yield
    monkeypatch.undo()
    jpaths.refresh()


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _nii(path, shape=(4, 5, 6), dtype=np.float32, value=None, seed=0):
    data = (np.random.RandomState(seed).rand(*shape) * 10).astype(dtype) if value is None \
        else np.full(shape, value, dtype)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_nifti(str(path), data, spacing_xyz=(1, 1.5, 2))
    return data


def _set_roots(root, monkeypatch):
    for which in ("raw", "preprocessed", "results"):
        os.makedirs(root / which, exist_ok=True)
        monkeypatch.setenv(f"ATK_{which}", str(root / which))
    jpaths.refresh()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_file(a, b):
    if a.endswith(".json"):
        assert json.load(open(a)) == json.load(open(b)), a
    elif a.endswith((".nii.gz", ".nii")):
        (da, ha), (db, hb) = read_nifti(a), read_nifti(b)
        assert da.dtype == db.dtype, a
        np.testing.assert_array_equal(da, db, err_msg=a)
        for k in ("spacing", "affine", "qform_code", "sform_code"):
            if k in ha or k in hb:
                np.testing.assert_array_equal(np.asarray(ha.get(k)), np.asarray(hb.get(k)),
                                              err_msg=f"{a} {k}")
    elif a.endswith((".png", ".tif")):
        np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)),
                                      err_msg=a)
    else:
        assert open(a, "rb").read() == open(b, "rb").read(), a


def _run_both(tmp_path, monkeypatch, call):
    """call(pkg) once per package, each with its own ATK_* tree; the two trees
    must hold the same files with the same contents. Returns the port's
    tree and call's return values {pkg: value}."""
    out = {}
    for pkg in (JAX, PORT):
        root = tmp_path / pkg
        _set_roots(root, monkeypatch)
        out[pkg] = call(pkg)
    a, b = tmp_path / JAX, tmp_path / PORT
    assert _files(a) == _files(b)
    assert _files(b), "the converter wrote nothing"
    for rel in _files(a):
        _same_file(str(a / rel), str(b / rel))
    return b, out


def _msd(src):
    task = src / "Task04_Hippo"
    for name, chans in (("hippo_001", 2), ("hippo_003", 2)):
        _nii(task / "imagesTr" / f"{name}.nii.gz", (4, 5, 6, chans), seed=len(name))
        _nii(task / "labelsTr" / f"{name}.nii.gz", dtype=np.uint8, value=1)
    _nii(task / "imagesTs" / "hippo_002.nii.gz", (4, 5, 6, 2), seed=3)
    json.dump({"name": "Hippo", "modality": {"0": "MRI", "1": "T2"},
               "labels": {"0": "background", "1": "anterior", "2": "posterior"},
               "training": [{"image": f"./imagesTr/{n}.nii.gz", "label": f"./labelsTr/{n}.nii.gz"}
                            for n in ("hippo_001", "hippo_003")],
               "test": ["./imagesTs/hippo_002.nii.gz"], "reference": "Vanderbilt",
               "licence": "CC-BY-SA 4.0", "release": "1.0"}, open(task / "dataset.json", "w"))
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_msd").convert_msd_dataset(
        str(task), 5, 1)


def _kits(src):
    for c in ("case_00000", "case_00001"):
        _nii(src / c / "imaging.nii.gz")
        _nii(src / c / "segmentation.nii.gz", dtype=np.uint8, value=1)
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_challenges").convert_kits2023(str(src))


def _amos(src):
    os.makedirs(src, exist_ok=True)
    json.dump({"training": [{"image": "./imagesTr/amos_0001.nii.gz"},
                            {"image": "./imagesTr/amos_0500.nii.gz"}],
               "validation": [{"image": "./imagesVa/amos_0002.nii.gz"}],
               "test": [{"image": "./imagesTs/amos_0450.nii.gz"}],
               "labels": {"0": "background", "1": "spleen"}}, open(src / "dataset.json", "w"))
    for sub, name in (("imagesTr", "amos_0001"), ("imagesTr", "amos_0500"),
                      ("imagesVa", "amos_0002"), ("imagesTs", "amos_0450")):
        _nii(src / sub / f"{name}.nii.gz")
    for sub, name in (("labelsTr", "amos_0001"), ("labelsTr", "amos_0500"),
                      ("labelsVa", "amos_0002")):
        _nii(src / sub / f"{name}.nii.gz", dtype=np.uint8, value=0)

    def call(pkg):
        cc = _mod(pkg, "dataset_conversion.convert_challenges")
        return cc.convert_amos_task1(str(src)), cc.convert_amos_task2(str(src))
    return call


def _autopet(src):
    for pat in ("PETCT_a", "PETCT_b", "PETCT_c"):
        for acq in ("acq1", "acq2"):
            for f in ("CTres", "SUV"):
                _nii(src / pat / acq / f"{f}.nii.gz")
            _nii(src / pat / acq / "SEG.nii.gz", dtype=np.uint8, value=0)
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_challenges").convert_autopet(str(src))


def _mnms(src):
    for p, seed in (("P1", 0), ("P2", 1), ("P3", 2)):
        tdir = src / "Training" / "Labeled" / p
        vol = _nii(tdir / f"{p}_sa.nii.gz", (4, 5, 6, 8), seed=seed)
        os.makedirs(tdir, exist_ok=True)
        write_nifti(str(tdir / f"{p}_sa_gt.nii.gz"), (vol > 5).astype(np.uint8),
                    spacing_xyz=(1, 1, 1))
    _nii(src / "Testing" / "P4" / "P4_sa.nii.gz", (4, 5, 6, 8), seed=3)
    with open(src / "info.csv", "w") as f:
        f.write("External code,ED,ES,Vendor\nP1,1,5,A\nP2,0,4,B\nP3,2,6,A\nP4,1,3,B\n")

    def call(pkg):
        cc = _mod(pkg, "dataset_conversion.convert_challenges")
        out = cc.convert_mnms(str(src), "info.csv")
        splits = os.path.join(os.environ["ATK_preprocessed"], "Dataset114_MNMs",
                              "splits_final.json")
        os.makedirs(os.path.dirname(splits))
        json.dump([{"train": ["P1_frame01"], "val": ["P2_frame00"]}], open(splits, "w"))
        return out, cc.create_mnms_custom_splits(str(src), "info.csv", num_val_patients=1)
    return call


def _emidec(src):
    for c in ("Case_P001", "Case_P002"):
        _nii(src / c / "Images" / f"{c}.nii.gz")
        _nii(src / c / "Contours" / f"{c}.nii.gz", dtype=np.uint8, value=2)
    test = src.parent / "emidec_test"
    _nii(test / "Case_P003" / "Images" / "Case_P003.nii.gz")
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_challenges").convert_emidec(
        str(src), str(test))


def _fluo(src):
    test = src.parent / "fluo_test"

    def tif(path, i):
        os.makedirs(path.parent, exist_ok=True)
        frames = [Image.fromarray((np.arange(42).reshape(6, 7) * (i + k)).astype(np.uint16))
                  for k in range(3)]
        frames[0].save(str(path), save_all=True, append_images=frames[1:])

    for seq in ("01", "02"):
        for i in range(2):
            tif(src / seq / f"t{i:03d}.tif", i)
            tif(src / (seq + "_GT") / "SEG" / f"man_seg{i:03d}.tif", i + 1)
            tif(test / seq / f"t{i:03d}.tif", i + 2)
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_challenges"
                            ).convert_fluo_c3dh_a549_sim(str(src), str(test))


def _roads(src):
    img = (np.random.RandomState(0).rand(32, 32, 3) * 200).astype(np.uint8)
    img[:16, :16] = 255
    seg = np.zeros((32, 32), np.uint8)
    seg[4:28, 10:14] = 255
    for sub, case in (("training", "case1"), ("testing", "case2")):
        for part in ("input", "output"):
            os.makedirs(src / sub / part)
        Image.fromarray(img).save(str(src / sub / "input" / f"{case}.png"))
        Image.fromarray(seg).save(str(src / sub / "output" / f"{case}.png"))
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_challenges"
                            ).convert_road_segmentation(str(src))


def _old_nnunet(src):
    task = src / "Task01_Old"
    _nii(task / "imagesTr" / "c1_0000.nii.gz")
    _nii(task / "labelsTr" / "c1.nii.gz", dtype=np.uint8, value=0)
    _nii(task / "imagesTs" / "c2_0000.nii.gz")
    json.dump({"modality": {"0": "CT"}, "labels": {"0": "background", "1": "organ"},
               "numTraining": 1, "numTest": 1, "training": [], "test": [],
               "tensorImageSize": "3D"}, open(task / "dataset.json", "w"))
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_challenges"
                            ).convert_old_nnunet_dataset(str(task), "Dataset901_Old")


def _acdc(src):
    for p in ("patient001", "patient002"):
        for fr in ("01", "12"):
            _nii(src / p / f"{p}_frame{fr}.nii.gz")
            _nii(src / p / f"{p}_frame{fr}_gt.nii.gz", dtype=np.uint8, value=3)
        _nii(src / p / f"{p}_4d.nii.gz", (4, 5, 6, 2))
    return lambda pkg: _mod(pkg, "dataset_conversion.convert_acdc").convert_acdc_dataset(str(src))


def _brats(src):
    seg = np.random.RandomState(1).randint(0, 5, (4, 5, 6)).astype(np.uint8)
    for case, sep, mods in (("BraTS_001", "_", ("t1", "t1ce", "t2", "flair")),
                            ("BraTS-002", "-", ("t1n", "t1c", "t2w", "t2f"))):
        for m in mods:
            _nii(src / case / f"{case}{sep}{m}.nii.gz")
        write_nifti(str(src / case / f"{case}{sep}seg.nii.gz"), seg, spacing_xyz=(1, 1, 1))
    preds = src / "preds"
    os.makedirs(preds)
    write_nifti(str(preds / "BraTS_001.nii.gz"), seg % 4, spacing_xyz=(1, 1, 1))

    def call(pkg):
        cb = _mod(pkg, "dataset_conversion.convert_brats")
        back = os.path.join(os.environ["ATK_results"], "brats_back")
        return (cb.convert_brats_dataset(str(src), 137),
                cb.convert_brats_dataset(str(src), 138, use_regions=False),
                cb.convert_folder_back_to_brats(str(preds), back))
    return call


def _integration(src):
    return lambda pkg: [_mod(pkg, "dataset_conversion.integration_test_datasets")
                        .generate_integration_test_dataset(996 + i, scheme, num_cases=2,
                                                           shape=(14, 15, 16))
                        for i, scheme in enumerate(("regions_ignore", "regions", "ignore",
                                                    "labels"))]


CONVERTERS = {"msd": _msd, "kits23": _kits, "amos": _amos, "autopet": _autopet,
              "mnms": _mnms, "emidec": _emidec, "fluo_c3dh": _fluo, "roads": _roads,
              "old_nnunet": _old_nnunet, "acdc": _acdc, "brats": _brats,
              "integration": _integration}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converter_matches_jax(name, tmp_path, monkeypatch):
    call = CONVERTERS[name](tmp_path / "source")
    port_root, out = _run_both(tmp_path, monkeypatch, call)
    norm = json.dumps(out[JAX], default=str).replace(str(tmp_path / JAX), "<root>")
    assert norm == json.dumps(out[PORT], default=str).replace(str(port_root), "<root>")


def test_collect_and_summarize_results_match_jax(tmp_path, monkeypatch):
    """collect_results, summarize_collected_results and
    summarize_benchmark_results of both packages on one results tree: the
    same CSVs and tables."""
    res = tmp_path / "results"
    monkeypatch.setenv("ATK_results", str(res))
    jpaths.refresh()
    name = "Dataset009_Spleen"
    for model, dices in (("ATKTrainer__ATKPlans__3d_fullres", (0.8, 0.9, None)),
                         ("ATKTrainer__ATKPlans__2d", (0.5, 0.6, 0.7))):
        for fold, dice in enumerate(dices):
            if dice is not None:
                path = res / name / model / f"fold_{fold}" / "validation" / "summary.json"
                os.makedirs(path.parent)
                json.dump({"foreground_mean": {"Dice": dice}}, open(path, "w"))
    bench = res / name / "ATKTrainerBenchmark_5epochs__ATKPlans__3d_fullres" / "fold_0"
    os.makedirs(bench)
    json.dump({"H100": {"fastest_epoch": 12.5}}, open(bench / "benchmark_result.json", "w"))
    outs = {}
    for pkg in (JAX, PORT):
        br = _mod(pkg, "utils.batch_running")
        csv, summary = tmp_path / f"{pkg}.csv", tmp_path / f"{pkg}_summary.csv"
        br.collect_results({"ATKTrainer": ("ATKPlans",)}, [9], str(csv),
                           configurations=("2d", "3d_fullres"), folds=(0, 1, 2))
        br.summarize_collected_results(str(csv), str(summary), folds=(0, 1), configs=("2d",
                                       "3d_fullres"), datasets=[9],
                                       trainers={"ATKTrainer": ("ATKPlans",)})
        table = br.summarize_benchmark_results([9], str(tmp_path / f"{pkg}_bench.json"))
        outs[pkg] = (open(csv).read(), open(summary).read(), table,
                     json.load(open(tmp_path / f"{pkg}_bench.json")))
    assert outs[JAX] == outs[PORT]


def test_batch_commands_match_jax_but_the_entry_name():
    """generate_training_commands, generate_benchmark_commands and
    wrap_commands_for_scheduler (lsf, slurm, none): JAX's lines with
    `atk_train` replaced by the port's `atk_torch_train`."""
    jbr, tbr = _mod(JAX, "utils.batch_running"), _mod(PORT, "utils.batch_running")
    args = ([137, "Dataset004_Hippocampus"], ("2d", "3d_fullres"), ("ATKTrainer", "T2"),
            ("ATKPlans",), (0, 3), "--npz")
    want = jbr.generate_training_commands(*args)
    got = tbr.generate_training_commands(*args)
    assert len(got) == 16 and all(c.startswith("atk_torch_train ") for c in got)
    assert got == [c.replace("atk_train ", "atk_torch_train ", 1) for c in want]
    assert tbr.generate_benchmark_commands([4]) == [
        c.replace("atk_train ", "atk_torch_train ", 1) for c in jbr.generate_benchmark_commands([4])]
    for scheduler in ("lsf", "slurm", "none"):
        kw = dict(scheduler_args="-q gpu -n 1", preamble="source 'env.sh' && ")
        assert tbr.wrap_commands_for_scheduler(got, scheduler, **kw) == [
            c.replace("atk_train ", "atk_torch_train ", 1)
            for c in jbr.wrap_commands_for_scheduler(want, scheduler, **kw)]
    with pytest.raises(ValueError):
        tbr.wrap_commands_for_scheduler(got, "pbs")


def test_collate_outputs_matches_jax():
    jc, tc = _mod(JAX, "utils.collate"), _mod(PORT, "utils.collate")
    rs = np.random.RandomState(2)
    outputs = [{"loss": float(rs.rand()), "tp": rs.rand(3), "n": i} for i in range(4)]
    want, got = jc.collate_outputs(outputs), tc.collate_outputs(outputs)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for mod in (jc, tc):
        with pytest.raises(ValueError):
            mod.collate_outputs([{"x": [1, 2]}])


def test_overlays_match_jax(tmp_path):
    """generate_overlay's RGB slices equal JAX's; with matplotlib present the
    PNGs of generate_overlays_for_folder decode to the same pixels."""
    jo, to = _mod(JAX, "utils.overlay_plots"), _mod(PORT, "utils.overlay_plots")
    rs = np.random.RandomState(4)
    image = rs.rand(9, 10, 11).astype(np.float32) * 300
    seg = np.zeros((9, 10, 11), np.uint8)
    seg[3:6, 2:8, 4:9] = 1
    seg[4, 3:5, 5:7] = 12  # beyond the palette: clipped to its last color
    for axis in (0, 1, 2):
        np.testing.assert_array_equal(to.generate_overlay(image, seg, axis),
                                      jo.generate_overlay(image, seg, axis))
        assert to.select_slice(seg, axis) == jo.select_slice(seg, axis)
    pytest.importorskip("matplotlib")
    images, segs = tmp_path / "images", tmp_path / "segs"
    for case in ("a", "b"):
        _nii(images / f"{case}_0000.nii.gz", (9, 10, 11), seed=ord(case))
        os.makedirs(segs, exist_ok=True)
        write_nifti(str(segs / f"{case}.nii.gz"), seg, spacing_xyz=(1, 1, 1))
    dj = {"file_ending": ".nii.gz", "channel_names": {"0": "CT"}}
    jo.generate_overlays_for_folder(str(images), str(segs), str(tmp_path / JAX), dj)
    to.generate_overlays_for_folder(str(images), str(segs), str(tmp_path / PORT), dj)
    assert _files(tmp_path / JAX) == _files(tmp_path / PORT) == ["a.png", "b.png"]
    for f in ("a.png", "b.png"):
        _same_file(str(tmp_path / JAX / f), str(tmp_path / PORT / f))


def _parser(entry, monkeypatch):
    """The argparse parser that `entry` builds, taken as it parses."""
    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        raise Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Parsed) as e:
            entry([])
    return e.value.args[0]


def _options(parser):
    """{dest: (option strings, default, nargs, type, choices, required)}, with
    each subcommand's parser's options in place of its choices."""
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        if isinstance(a, argparse._SubParsersAction):
            out[a.dest] = {name: _options(sp) for name, sp in a.choices.items()}
            continue
        out[a.dest] = (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices,
                       a.required)
    return out


@pytest.mark.parametrize("name", ["convert_msd", "convert_challenge", "plot_overlay_pngs"])
def test_new_entries_parse_as_jax(name, monkeypatch):
    jcli = importlib.import_module("anatomask_tpu.cli")
    port = _parser(getattr(cli, f"{name}_entry"), monkeypatch)
    jax = _parser(getattr(jcli, f"{name}_entry"), monkeypatch)
    assert port.prog == f"atk_torch_{name}" and jax.prog == f"atk_{name}"
    assert _options(port) == _options(jax)

"""anatomask_torch.imageio against anatomask_tpu.imageio on the CPU: the
cases of tests/test_imageio.py through the port's readers and writers, each
with files written by one package and read by the other (both directions),
arrays and properties held equal. Inputs come from numpy seeds."""
import json
import struct

import numpy as np
import pytest

from anatomask_tpu.imageio import meta_image as jmeta
from anatomask_tpu.imageio import minc_io as jminc
from anatomask_tpu.imageio import natural_image as jnat
from anatomask_tpu.imageio import nifti as jnifti
from anatomask_tpu.imageio import numpy_io as jnumpy
from anatomask_tpu.imageio import registry as jreg
from anatomask_tpu.imageio import tiff_io as jtiff
from anatomask_torch.imageio import meta_image as tmeta
from anatomask_torch.imageio import minc_io as tminc
from anatomask_torch.imageio import natural_image as tnat
from anatomask_torch.imageio import nifti as tnifti
from anatomask_torch.imageio import numpy_io as tnumpy
from anatomask_torch.imageio import registry as treg
from anatomask_torch.imageio import tiff_io as ttiff
from anatomask_torch.plans.plans_handler import PlansManager

# the port writes and JAX reads, and back
DIRECTIONS = ["port_to_jax", "jax_to_port"]


def _pair(port, jax, direction):
    """(writer, reader) modules."""
    return (port, jax) if direction == "port_to_jax" else (jax, port)


def _same_props(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_props(a[k], b[k])
        else:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_nifti_write_read(tmp_path, direction):
    w, r = _pair(tnifti, jnifti, direction)
    data = np.random.RandomState(100).rand(7, 9, 11).astype(np.float32)
    f = str(tmp_path / "img.nii.gz")
    w.write_nifti(f, data, spacing_xyz=(1.5, 2.0, 2.5))
    back, hdr = r.read_nifti(f)
    np.testing.assert_array_equal(back, data)
    assert hdr["pixdim"][1:4] == pytest.approx((1.5, 2.0, 2.5))
    _same_props(tnifti.read_nifti(f)[1], jnifti.read_nifti(f)[1])


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_nifti_io_channels_spacing_and_seg_geometry(tmp_path, direction):
    """Two channel files read as (c, z, y, x) with spacing reversed; a
    segmentation written with the reader's properties keeps the geometry."""
    w, r = _pair(tnifti, jnifti, direction)
    vol = np.random.RandomState(101).rand(6, 8, 10).astype(np.float32)  # disk (x, y, z)
    files = [str(tmp_path / f"case_{c:04d}.nii.gz") for c in range(2)]
    for c, f in enumerate(files):
        w.write_nifti(f, vol + c, spacing_xyz=(1.0, 2.0, 3.0))
    img, props = r.NiftiIO().read_images(files)
    ref, ref_props = w.NiftiIO().read_images(files)
    np.testing.assert_array_equal(img, ref)
    _same_props(props, ref_props)
    assert img.shape == (2, 10, 8, 6)
    assert props["spacing"] == pytest.approx([3.0, 2.0, 1.0])
    seg = (img[0] > 0.5).astype(np.uint8)
    out = str(tmp_path / "seg.nii.gz")
    w.NiftiIO().write_seg(seg, out, ref_props)
    seg_back, props_back = r.NiftiIO().read_seg(out)
    np.testing.assert_array_equal(seg_back[0].astype(np.uint8), seg)
    _same_props(props_back, w.NiftiIO().read_seg(out)[1])


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_nifti_scl_slope_applied(tmp_path, direction):
    w, r = _pair(tnifti, jnifti, direction)
    data = (np.random.RandomState(102).rand(4, 4, 4) * 100).astype(np.int16)
    f = str(tmp_path / "scaled.nii")
    w.write_nifti(f, data, spacing_xyz=(1, 1, 1))
    raw = bytearray(open(f, "rb").read())
    struct.pack_into("<f", raw, 112, 2.0)   # scl_slope
    struct.pack_into("<f", raw, 116, 10.0)  # scl_inter
    open(f, "wb").write(bytes(raw))
    back, _ = r.read_nifti(f)
    np.testing.assert_allclose(back, data.astype(np.float32) * 2 + 10, rtol=1e-6)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_reorient_io_round_trip(tmp_path, direction):
    """NiftiIOWithReorient: a non-RAS volume reads RAS-aligned, and write_seg
    restores the original orientation and affine."""
    w, r = _pair(tnifti, jnifti, direction)
    disk = (np.random.RandomState(103).rand(5, 6, 7) * 40).astype(np.float32)
    A = np.zeros((4, 4))
    A[3, 3] = 1
    A[0, 2], A[1, 1], A[2, 0] = -1.3, -0.7, 2.0
    A[:3, 3] = (10., 20., 30.)
    f = str(tmp_path / "weird.nii.gz")
    w.write_nifti(f, np.ascontiguousarray(disk), affine=A)
    img, props = r.NiftiIOWithReorient().read_images([f])
    ref, ref_props = w.NiftiIOWithReorient().read_images([f])
    np.testing.assert_array_equal(img, ref)
    _same_props(props, ref_props)
    np.testing.assert_allclose(props["spacing"], [2.0, 0.7, 1.3], atol=1e-6)
    out = str(tmp_path / "seg.nii.gz")
    r.NiftiIOWithReorient().write_seg((img[0] > 20).astype(np.uint8), out, props)
    seg_disk, h = w.read_nifti(out)
    np.testing.assert_array_equal(seg_disk, (disk > 20).astype(np.uint8))
    np.testing.assert_allclose(h["affine"], A, atol=1e-5)


def test_plain_reader_warns_on_noncanonical(tmp_path, capsys):
    f = str(tmp_path / "flip.nii.gz")
    jnifti.write_nifti(f, np.zeros((4, 4, 4), np.float32), affine=np.diag([-1.0, 1, 1, 1]))
    tnifti._WARNED_NONCANONICAL = False
    tnifti.NiftiIO().read_images([f])
    assert "not in canonical" in capsys.readouterr().out


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_numpy_io_round_trip(tmp_path, direction):
    w, r = _pair(tnumpy, jnumpy, direction)
    arr = np.random.RandomState(104).rand(5, 6, 7).astype(np.float32)
    np.save(tmp_path / "case_0000.npy", arr)
    img, props = r.NumpyIO().read_images([str(tmp_path / "case_0000.npy")])
    assert img.shape == (1, 5, 6, 7)
    w.NumpyIO().write_seg((img[0] > 0.5).astype(np.uint8), str(tmp_path / "seg.npy"), props)
    seg, seg_props = r.NumpyIO().read_seg(str(tmp_path / "seg.npy"))
    np.testing.assert_array_equal(seg[0], (arr > 0.5).astype(np.uint8))
    _same_props(seg_props, w.NumpyIO().read_seg(str(tmp_path / "seg.npy"))[1])


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_natural_image_2d_io(tmp_path, direction):
    from PIL import Image
    w, r = _pair(tnat, jnat, direction)
    arr = (np.random.RandomState(105).rand(10, 12, 3) * 255).astype(np.uint8)
    f = str(tmp_path / "img.png")
    Image.fromarray(arr).save(f)
    img, props = r.NaturalImage2DIO().read_images([f])
    assert img.shape == (3, 1, 10, 12)
    seg = (img[0] > 128).astype(np.uint8)
    out = str(tmp_path / "seg.png")
    w.NaturalImage2DIO().write_seg(seg, out, props)
    back, _ = r.NaturalImage2DIO().read_seg(out)
    np.testing.assert_array_equal(back[0], seg)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tiff_3d_io(tmp_path, direction):
    from PIL import Image
    w, r = _pair(ttiff, jtiff, direction)
    vol = (np.random.RandomState(106).rand(5, 8, 9) * 200).astype(np.uint8)
    frames = [Image.fromarray(s) for s in vol]
    f = str(tmp_path / "case_0000.tif")
    frames[0].save(f, save_all=True, append_images=frames[1:])
    (tmp_path / "case_0000.json").write_text(json.dumps({"spacing": [2.0, 1.0, 1.0]}))
    img, props = r.Tiff3DIO().read_images([f])
    assert img.shape == (1, 5, 8, 9) and props["spacing"] == [2.0, 1.0, 1.0]
    seg = (img[0] > 100).astype(np.uint8)
    out = str(tmp_path / "seg.tif")
    w.Tiff3DIO().write_seg(seg, out, props)
    back, props2 = r.Tiff3DIO().read_seg(out)
    np.testing.assert_array_equal(back[0], seg)
    assert props2["spacing"] == [2.0, 1.0, 1.0]


@pytest.mark.parametrize("fmt", ["mha", "nrrd"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_meta_image_round_trip(tmp_path, direction, fmt):
    w, r = _pair(tmeta, jmeta, direction)
    vol = (np.random.RandomState(107).rand(6, 7, 8) * 100).astype(np.float32)  # (x, y, z)
    f = str(tmp_path / f"t.{fmt}")
    getattr(w, f"write_{fmt}")(f, vol, spacing_xyz=(1.5, 2.0, 2.5))
    data, h = getattr(r, f"read_{fmt}")(f)
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_allclose(h["spacing_xyz"], (1.5, 2.0, 2.5))
    img, props = r.MetaImageIO().read_images([f])
    assert img.shape == (1, 8, 7, 6) and list(props["spacing"]) == [2.5, 2.0, 1.5]
    seg = (img[0] > 50).astype(np.uint8)
    out = str(tmp_path / f"seg.{fmt}")
    w.MetaImageIO().write_seg(seg, out, props)
    seg_back, _ = r.MetaImageIO().read_seg(out)
    np.testing.assert_array_equal(seg_back[0], seg)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_minc_round_trip(tmp_path, direction):
    w, r = _pair(tminc, jminc, direction)
    seg = np.random.RandomState(108).randint(0, 4, (7, 6, 5)).astype(np.uint8)
    props = {"spacing": [1.5, 2.0, 2.5], "minc_dims": {
        "xspace": {"step": 1.5, "start": -3.0, "direction_cosines": [1, 0, 0]},
        "yspace": {"step": 2.0, "start": 1.0, "direction_cosines": [0, 1, 0]},
        "zspace": {"step": -2.5, "start": 9.0, "direction_cosines": [0, 0, 1]}}}
    f = str(tmp_path / "t.mnc")
    w.MincIO().write_seg(seg, f, props)
    data, p = r.MincIO().read_seg(f)
    np.testing.assert_array_equal(data[0], seg)
    assert p["spacing"] == [1.5, 2.0, 2.5]
    assert p["minc_dims"]["zspace"]["start"] == 9.0
    np.testing.assert_array_equal(r.read_minc(f)[0], seg)


def test_minc_integer_rescale(tmp_path):
    """Integer volumes with per-slice image-min/image-max rescale to real
    values, as in JAX."""
    import h5py
    stored = np.arange(2 * 3 * 4, dtype=np.uint16).reshape(2, 3, 4)  # z, y, x
    f = str(tmp_path / "scaled.mnc")
    with h5py.File(f, "w") as h:
        root = h.create_group("minc-2.0")
        dgrp = root.create_group("dimensions")
        for i, name in enumerate(("zspace", "yspace", "xspace")):
            g = dgrp.create_group(name)
            g.attrs["step"], g.attrs["start"], g.attrs["length"] = 1.0, 0.0, stored.shape[i]
        img = root.create_group("image").create_group("0")
        ds = img.create_dataset("image", data=stored)
        ds.attrs["dimorder"] = "zspace,yspace,xspace"
        ds.attrs["valid_range"] = np.array([0, 65535], np.float64)
        img.create_dataset("image-min", data=np.array([0.0, 10.0]))
        img.create_dataset("image-max", data=np.array([65535.0, 65545.0]))
    data, props = tminc.read_minc(f)
    ref, ref_props = jminc.read_minc(f)
    np.testing.assert_array_equal(data, ref)
    expect = stored.astype(np.float32)
    expect[1] += 10.0
    np.testing.assert_allclose(data.transpose(2, 1, 0), expect, atol=1e-3)


def test_registry_resolves_every_jax_name_and_ending():
    """Every name of the JAX registry (nnU-Net's aliases too) and every file
    ending resolves to the port's class of the same name; the plans accessor
    goes through it."""
    for name, cls in jreg._REGISTRY.items():
        assert treg.find_reader_writer_by_name(name).__name__ == cls.__name__
        assert treg.find_reader_writer_by_name(name).__module__.startswith("anatomask_torch.")
    for endings, cls in jreg._ENDING_MAP:
        for e in endings:
            assert treg.determine_reader_writer_from_file_ending(e).__name__ == cls.__name__
    assert treg.determine_reader_writer_from_dataset_json(
        {"file_ending": ".nii.gz", "overwrite_image_reader_writer": "NumpyIO"}) is tnumpy.NumpyIO
    assert PlansManager({"image_reader_writer": "NibabelIO"}).image_reader_writer_class \
        is tnifti.NiftiIO
    with pytest.raises(RuntimeError, match="Unknown reader"):
        treg.find_reader_writer_by_name("ITKIO")


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_simpleitkio_alias_dispatches_by_ending(tmp_path, direction):
    w, r = _pair(treg, jreg, direction)
    seg = np.random.RandomState(109).randint(0, 3, (5, 6, 7)).astype(np.uint8)
    for ending in (".mha", ".mnc", ".nii.gz"):
        f = str(tmp_path / ("x" + ending))
        w.find_reader_writer_by_name("SimpleITKIO")().write_seg(seg, f, {"spacing": [1.0] * 3})
        data, _ = r.find_reader_writer_by_name("SimpleITKIO")().read_seg(f)
        np.testing.assert_array_equal(data[0], seg)

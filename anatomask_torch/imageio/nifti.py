"""Pure-numpy NIfTI-1 reader/writer (.nii / .nii.gz): the port's own copy of
anatomask_tpu/imageio/nifti.py.

nnU-Net delegates NIfTI decoding to SimpleITK or nibabel; this is a
self-contained implementation of the NIfTI-1 on-disk format
(https://nifti.nimh.nih.gov/nifti-1), so it needs neither. Geometry
(qform/sform, full raw header) is carried through `properties` so write_seg
round-trips the original file's affine bit-for-bit.

Axis convention (nnU-Net's SimpleITKIO's): on-disk NIfTI data is
Fortran-ordered (x fastest); we return a C-ordered array with axes (z, y, x)
and `spacing` = [sz, sy, sx] so spacing[i] matches array axis i.
"""
from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

from anatomask_torch.imageio.base import BaseReaderWriter

_HDR_SIZE = 348
_WARNED_NONCANONICAL = False

# NIfTI datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open_maybe_gz(fname: str, mode: str):
    if fname.endswith(".gz"):
        return gzip.open(fname, mode)
    return open(fname, mode)


def _parse_header(hdr: bytes) -> dict:
    if len(hdr) < _HDR_SIZE:
        raise IOError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    if sizeof_hdr == 348:
        endian = "<"
    elif struct.unpack_from(">i", hdr, 0)[0] == 348:
        endian = ">"
    else:
        raise IOError(f"not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    magic = hdr[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise IOError(f"bad NIfTI magic: {magic!r}")

    u = lambda fmt, off: struct.unpack_from(endian + fmt, hdr, off)
    dim = u("8h", 40)
    datatype = u("h", 70)[0]
    pixdim = u("8f", 76)
    vox_offset = u("f", 108)[0]
    scl_slope = u("f", 112)[0]
    scl_inter = u("f", 116)[0]
    qform_code = u("h", 252)[0]
    sform_code = u("h", 254)[0]
    quatern = u("3f", 256)
    qoffset = u("3f", 268)
    srow_x = u("4f", 280)
    srow_y = u("4f", 296)
    srow_z = u("4f", 312)

    ndim = dim[0]
    shape = tuple(int(d) for d in dim[1 : 1 + max(ndim, 3)])
    # pad to at least 3 spatial dims
    while len(shape) < 3:
        shape = shape + (1,)

    return dict(
        endian=endian,
        shape=shape,
        ndim=ndim,
        datatype=datatype,
        pixdim=tuple(float(p) for p in pixdim),
        vox_offset=int(vox_offset) if vox_offset > 0 else 352,
        scl_slope=scl_slope,
        scl_inter=scl_inter,
        qform_code=qform_code,
        sform_code=sform_code,
        quatern=quatern,
        qoffset=qoffset,
        srow=(srow_x, srow_y, srow_z),
        magic=bytes(magic),
    )


def _affine_from_header(h: dict) -> np.ndarray:
    """4x4 voxel->world affine; sform preferred, then qform, then pixdim scaling."""
    if h["sform_code"] > 0:
        aff = np.eye(4)
        aff[0, :] = h["srow"][0]
        aff[1, :] = h["srow"][1]
        aff[2, :] = h["srow"][2]
        return aff
    if h["qform_code"] > 0:
        b, c, d = h["quatern"]
        a2 = max(0.0, 1.0 - b * b - c * c - d * d)
        a = np.sqrt(a2)
        R = np.array([
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ])
        qfac = -1.0 if h["pixdim"][0] == -1.0 else 1.0
        S = np.diag([h["pixdim"][1], h["pixdim"][2], h["pixdim"][3] * qfac])
        aff = np.eye(4)
        aff[:3, :3] = R @ S
        aff[:3, 3] = h["qoffset"]
        return aff
    aff = np.diag([h["pixdim"][1], h["pixdim"][2], h["pixdim"][3], 1.0])
    return aff


def read_nifti(fname: str) -> Tuple[np.ndarray, dict]:
    """Read a NIfTI-1 file -> (data array in on-disk (x,y,z[,t]) index order, header dict)."""
    with _open_maybe_gz(fname, "rb") as f:
        raw = f.read()
    h = _parse_header(raw[:_HDR_SIZE])
    if h["magic"][:3] == b"ni1":
        raise IOError(".hdr/.img pairs are not supported; use single-file .nii(.gz)")
    dt = np.dtype(_DTYPES[h["datatype"]]).newbyteorder(h["endian"])
    count = int(np.prod(h["shape"]))
    data = np.frombuffer(raw, dtype=dt, count=count, offset=h["vox_offset"])
    # NIfTI voxel data is Fortran-ordered: first index (x) varies fastest.
    data = data.reshape(h["shape"], order="F")
    slope, inter = h["scl_slope"], h["scl_inter"]
    if slope not in (0.0, 1.0) or (slope != 0.0 and inter != 0.0):
        data = data.astype(np.float32) * slope + inter
    h["affine"] = _affine_from_header(h)
    h["raw_header"] = raw[:_HDR_SIZE]
    return np.asarray(data), h


def write_nifti(fname: str, data_xyz: np.ndarray, header: dict = None, affine: np.ndarray = None,
                spacing_xyz=None):
    """Write (x, y, z) array to NIfTI-1. If `header` has raw_header bytes, geometry
    fields are copied from it (round-trip); otherwise built from affine/spacing."""
    data_xyz = np.ascontiguousarray(data_xyz)
    dt = np.dtype(data_xyz.dtype)
    if dt not in _DTYPE_CODES:
        # promote unusual int types
        if np.issubdtype(dt, np.integer):
            data_xyz = data_xyz.astype(np.int32)
        else:
            data_xyz = data_xyz.astype(np.float32)
        dt = data_xyz.dtype
    code = _DTYPE_CODES[np.dtype(dt)]

    hdr = bytearray(352)  # 348 header + 4 extension bytes
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data_xyz.ndim, *data_xyz.shape, 1, 1, 1, 1][:8]
    dim += [1] * (8 - len(dim))
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data_xyz.dtype.itemsize * 8)  # bitpix

    if header is not None and "raw_header" in header:
        src = header["raw_header"]
        # copy pixdim, xyzt_units, qform/sform blocks from the source header
        hdr[76:108] = src[76:108]     # pixdim
        hdr[123:124] = src[123:124]   # xyzt_units
        hdr[252:348] = src[252:348]   # qform/sform/intent/magic region
    else:
        if affine is None:
            if spacing_xyz is None:
                spacing_xyz = (1.0, 1.0, 1.0)
            affine = np.diag([*spacing_xyz, 1.0])
        pix = [1.0] + [float(np.linalg.norm(affine[:3, i])) for i in range(3)] + [0, 0, 0, 0]
        struct.pack_into("<8f", hdr, 76, *pix)
        struct.pack_into("<h", hdr, 254, 1)  # sform_code = 1
        struct.pack_into("<4f", hdr, 280, *affine[0, :])
        struct.pack_into("<4f", hdr, 296, *affine[1, :])
        struct.pack_into("<4f", hdr, 312, *affine[2, :])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    hdr[344:348] = b"n+1\x00"

    body = np.asfortranarray(data_xyz).tobytes(order="F")
    with _open_maybe_gz(fname, "wb") as f:
        f.write(bytes(hdr))
        f.write(body)


def io_orientation(affine: np.ndarray) -> np.ndarray:
    """For each voxel axis v: (world axis w it most aligns with, sign). RAS
    canonical == [(0,+1),(1,+1),(2,+1)]. Greedy max-|cosine| assignment
    (nibabel io_orientation equivalent for orthogonal-ish affines)."""
    R = np.asarray(affine, np.float64)[:3, :3]
    lengths = np.sqrt((R ** 2).sum(0))
    lengths[lengths == 0] = 1.0
    Rn = R / lengths
    ornt = np.zeros((3, 2))
    pairs = sorted(((abs(Rn[w, v]), w, v) for w in range(3) for v in range(3)),
                   reverse=True)
    used_w, used_v = set(), set()
    for mag, w, v in pairs:
        if w in used_w or v in used_v:
            continue
        ornt[v] = (w, 1.0 if Rn[w, v] >= 0 else -1.0)
        used_w.add(w)
        used_v.add(v)
        if len(used_v) == 3:
            break
    return ornt


def reorient_to_ras(data_xyz: np.ndarray, affine: np.ndarray):
    """Reorient an (x,y,z)-indexed volume so voxel axes align with +x,+y,+z
    world axes. Returns (data_ras, affine_ras, ornt)."""
    ornt = io_orientation(affine)
    d = data_xyz
    for v in range(3):
        if ornt[v, 1] < 0:
            d = np.flip(d, axis=v)
    # output axis w <- input axis v with ornt[v,0]==w
    axes = [0, 0, 0]
    for v in range(3):
        axes[int(ornt[v, 0])] = v
    d = np.transpose(d, axes)
    # new affine: A_ras = A @ M, M maps new index -> old index
    M = np.zeros((4, 4))
    M[3, 3] = 1.0
    for v in range(3):
        w, s = int(ornt[v, 0]), ornt[v, 1]
        M[v, w] = s
        M[v, 3] = (data_xyz.shape[v] - 1) if s < 0 else 0.0
    return np.ascontiguousarray(d), np.asarray(affine) @ M, ornt


def undo_reorientation(data_ras: np.ndarray, ornt: np.ndarray) -> np.ndarray:
    """Inverse of reorient_to_ras' data transform."""
    d = np.transpose(data_ras, axes=[int(ornt[v, 0]) for v in range(3)])
    for v in range(3):
        if ornt[v, 1] < 0:
            d = np.flip(d, axis=v)
    return np.ascontiguousarray(d)


class NiftiIO(BaseReaderWriter):
    """Default reader/writer for .nii / .nii.gz (reference default: SimpleITKIO)."""

    supported_file_endings = [".nii", ".nii.gz"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings, affines, headers = [], [], [], []
        for f in image_fnames:
            data, h = read_nifti(f)
            if data.ndim == 4:
                if data.shape[3] != 1:
                    raise RuntimeError(f"only 3D images supported, got shape {data.shape} in {f}")
                data = data[..., 0]
            elif data.ndim == 2:
                data = data[..., None]
            # (x,y,z) disk order -> (z,y,x) array order, spacing aligned
            images.append(np.ascontiguousarray(data.transpose(2, 1, 0)).astype(np.float32))
            spacings.append([float(h["pixdim"][3]), float(h["pixdim"][2]), float(h["pixdim"][1])])
            affines.append(h["affine"])
            headers.append(h)

        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image channel shapes differ: {[i.shape for i in images]} ({image_fnames})")
        if not self._check_all_same_array([np.asarray(s) for s in spacings]):
            raise RuntimeError(f"image channel spacings differ: {spacings} ({image_fnames})")

        ornt = io_orientation(affines[0])
        if (ornt[:, 0] != np.arange(3)).any() or (ornt[:, 1] < 0).any():
            global _WARNED_NONCANONICAL
            if not _WARNED_NONCANONICAL:
                _WARNED_NONCANONICAL = True
                print("WARNING: NIfTI volume is not in canonical (RAS-aligned) "
                      "orientation; NiftiIO reads the raw array. For "
                      "mixed-orientation datasets set "
                      "'overwrite_image_reader_writer': 'NibabelIOWithReorient' "
                      "in dataset.json to reorient on read.")
        properties = {
            "spacing": spacings[0],
            "nifti_header": headers[0]["raw_header"],
            "affine": affines[0],
        }
        return np.stack(images).astype(np.float32), properties

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3, "expected (x, y, z)-indexed 3D segmentation (array axes z,y,x)"
        dtype = np.uint8 if seg.max() < 255 else np.uint16
        # array (z,y,x) -> disk (x,y,z)
        data_xyz = seg.astype(dtype).transpose(2, 1, 0)
        header = {"raw_header": properties["nifti_header"]} if "nifti_header" in properties else None
        sp = properties.get("spacing", [1.0, 1.0, 1.0])
        write_nifti(output_fname, data_xyz, header=header,
                    affine=properties.get("affine"), spacing_xyz=sp[::-1])


class NiftiIOWithReorient(NiftiIO):
    """RAS-reorienting NIfTI reader/writer (reference NibabelIOWithReorient,
    nibabel_reader_writer.py:100-185): every volume is reoriented to the
    closest-to-RAS canonical orientation on read (axis permutation + flips from
    the affine), and segmentations are un-reoriented back to the ORIGINAL
    orientation on write, restoring the original affine bit-for-bit. Use for
    mixed-orientation datasets, where the raw-array reader would silently
    misalign channels/cases."""

    supported_file_endings = [".nii", ".nii.gz"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings, affines_r, ornts, headers = [], [], [], [], []
        for f in image_fnames:
            data, h = read_nifti(f)
            if data.ndim == 4:
                if data.shape[3] != 1:
                    raise RuntimeError(f"only 3D images supported, got shape {data.shape} in {f}")
                data = data[..., 0]
            elif data.ndim == 2:
                data = data[..., None]
            d_ras, aff_ras, ornt = reorient_to_ras(data, h["affine"])
            images.append(np.ascontiguousarray(d_ras.transpose(2, 1, 0)).astype(np.float32))
            # spacing from the reoriented affine, reversed to (z, y, x)
            sp_xyz = [float(np.linalg.norm(aff_ras[:3, i])) for i in range(3)]
            spacings.append(sp_xyz[::-1])
            affines_r.append(aff_ras)
            ornts.append(ornt)
            headers.append(h)

        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(
                f"image channel shapes differ after RAS reorientation: "
                f"{[i.shape for i in images]} ({image_fnames})")
        if not self._check_all_same_array(affines_r):
            print(f"WARNING: reoriented affines differ across channels "
                  f"({image_fnames}); verify data/seg alignment.")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"image channel spacings differ: {spacings} ({image_fnames})")

        properties = {
            "spacing": spacings[0],
            "nifti_header": headers[0]["raw_header"],
            "affine": affines_r[0],
            "original_affine": headers[0]["affine"],
            "reorient_ornt": np.asarray(ornts[0]).tolist(),
        }
        return np.stack(images).astype(np.float32), properties

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3
        dtype = np.uint8 if seg.max() < 255 else np.uint16
        data_ras_xyz = seg.astype(dtype).transpose(2, 1, 0)
        ornt = np.asarray(properties["reorient_ornt"])
        data_orig = undo_reorientation(data_ras_xyz, ornt)
        header = {"raw_header": properties["nifti_header"]} if "nifti_header" in properties else None
        write_nifti(output_fname, data_orig, header=header,
                    affine=properties.get("original_affine"))

"""Pure-numpy MetaImage (.mha) and NRRD (.nrrd) readers/writers: the port's
own copy of anatomask_tpu/imageio/meta_image.py.

nnU-Net reads these through SimpleITK (its SimpleITKIO lists .mha/.nrrd);
here the two on-disk formats are implemented directly (both are simple
text-header + raw/gzip-blob containers):
- MetaImage: https://itk.org/Wiki/ITK/MetaIO/Documentation
- NRRD:      https://teem.sourceforge.net/nrrd/format.html

Axis convention matches NiftiIO: arrays are returned (c, z, y, x) with
spacing aligned (z, y, x); write_seg restores the original header geometry.
"""
from __future__ import annotations

import gzip
import zlib
from typing import Tuple

import numpy as np

from anatomask_torch.imageio.base import BaseReaderWriter

_MET_DTYPES = {
    "MET_CHAR": np.int8, "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16, "MET_USHORT": np.uint16,
    "MET_INT": np.int32, "MET_UINT": np.uint32,
    "MET_LONG": np.int64, "MET_ULONG": np.uint64,
    "MET_FLOAT": np.float32, "MET_DOUBLE": np.float64,
}
_MET_CODES = {np.dtype(v): k for k, v in _MET_DTYPES.items()}

_NRRD_DTYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8, "uint8_t": np.uint8,
    "short": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "int": np.int32, "int32": np.int32, "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "long long": np.int64, "int64": np.int64,
    "unsigned long long": np.uint64, "uint64": np.uint64,
    "float": np.float32, "double": np.float64,
}


def read_mha(fname: str) -> Tuple[np.ndarray, dict]:
    """-> (data in (x, y, z) index order [Fortran voxel order like NIfTI read],
    header dict with spacing/offset/direction + raw header lines)."""
    with open(fname, "rb") as f:
        raw = f.read()
    header = {}
    lines = []
    pos = 0
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("latin-1").rstrip("\r")
        pos = eol + 1
        lines.append(line)
        if "=" not in line:
            raise IOError(f"malformed MetaImage header line: {line!r}")
        key, val = (s.strip() for s in line.split("=", 1))
        header[key] = val
        if key == "ElementDataFile":
            break
    if header.get("ElementDataFile", "LOCAL").upper() != "LOCAL":
        raise IOError("only single-file .mha (ElementDataFile = LOCAL) is supported")
    ndims = int(header.get("NDims", 3))
    shape = tuple(int(s) for s in header["DimSize"].split())  # (x, y, z)
    dtype = np.dtype(_MET_DTYPES[header["ElementType"]])
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true" or \
            header.get("ElementByteOrderMSB", "False").lower() == "true":
        dtype = dtype.newbyteorder(">")
    blob = raw[pos:]
    if header.get("CompressedData", "False").lower() == "true":
        blob = zlib.decompress(blob)
    count = int(np.prod(shape)) * int(header.get("ElementNumberOfChannels", 1))
    data = np.frombuffer(blob, dtype=dtype, count=count)
    data = data.reshape(shape, order="F")  # x fastest on disk
    spacing = tuple(float(s) for s in header.get(
        "ElementSpacing", header.get("ElementSize", "1 1 1")).split())[:ndims]
    offset = tuple(float(s) for s in header.get("Offset", "0 0 0").split())[:ndims]
    direction = tuple(float(s) for s in header.get(
        "TransformMatrix", "1 0 0 0 1 0 0 0 1").split())
    return np.asarray(data), {
        "shape": shape, "spacing_xyz": spacing, "offset": offset,
        "direction": direction, "mha_header": {k: v for k, v in header.items()},
    }


def write_mha(fname: str, data_xyz: np.ndarray, header: dict = None,
              spacing_xyz=None, compressed: bool = True):
    h = dict((header or {}).get("mha_header", {}))
    if spacing_xyz is None:
        spacing_xyz = tuple(float(s) for s in h.get("ElementSpacing", "1 1 1").split()) \
            if "ElementSpacing" in h else (1.0, 1.0, 1.0)
    dt = np.dtype(data_xyz.dtype)
    if dt not in _MET_CODES:
        data_xyz = data_xyz.astype(np.float32 if np.issubdtype(dt, np.floating) else np.int32)
        dt = data_xyz.dtype
    body = np.asfortranarray(data_xyz).tobytes(order="F")
    if compressed:
        comp = zlib.compress(body)
    out = {
        "ObjectType": "Image",
        "NDims": str(data_xyz.ndim),
        "BinaryData": "True",
        "BinaryDataByteOrderMSB": "False",
        "CompressedData": "True" if compressed else "False",
    }
    if compressed:
        out["CompressedDataSize"] = str(len(comp))
    out["TransformMatrix"] = h.get("TransformMatrix", "1 0 0 0 1 0 0 0 1")
    out["Offset"] = h.get("Offset", "0 0 0")
    out["CenterOfRotation"] = h.get("CenterOfRotation", "0 0 0")
    if "AnatomicalOrientation" in h:
        out["AnatomicalOrientation"] = h["AnatomicalOrientation"]
    out["ElementSpacing"] = " ".join(str(s) for s in spacing_xyz)
    out["DimSize"] = " ".join(str(s) for s in data_xyz.shape)
    out["ElementType"] = _MET_CODES[np.dtype(dt)]
    out["ElementDataFile"] = "LOCAL"
    with open(fname, "wb") as f:
        for k, v in out.items():
            f.write(f"{k} = {v}\n".encode("latin-1"))
        f.write(comp if compressed else body)


def read_nrrd(fname: str) -> Tuple[np.ndarray, dict]:
    with open(fname, "rb") as f:
        raw = f.read()
    if not raw.startswith(b"NRRD"):
        raise IOError(f"{fname}: not a NRRD file")
    header = {}
    pos = raw.index(b"\n") + 1
    while True:
        eol = raw.index(b"\n", pos)
        line = raw[pos:eol].decode("latin-1").rstrip("\r")
        pos = eol + 1
        if line == "":
            break
        if line.startswith("#"):
            continue
        if ":=" in line:
            key, val = (s.strip() for s in line.split(":=", 1))
        else:
            key, val = (s.strip() for s in line.split(":", 1))
        header[key.lower()] = val
    shape = tuple(int(s) for s in header["sizes"].split())  # (x, y, z)
    dtype = np.dtype(_NRRD_DTYPES[header["type"]])
    endian = header.get("endian", "little")
    if endian == "big":
        dtype = dtype.newbyteorder(">")
    enc = header.get("encoding", "raw").lower()
    blob = raw[pos:]
    if enc in ("gzip", "gz"):
        blob = gzip.decompress(blob)
    elif enc not in ("raw",):
        raise IOError(f"unsupported NRRD encoding {enc!r}")
    data = np.frombuffer(blob, dtype=dtype, count=int(np.prod(shape)))
    data = data.reshape(shape, order="F")
    spacing = [1.0] * len(shape)
    if "space directions" in header:
        dirs = [v for v in header["space directions"].split(") ")
                if v.strip() not in ("none", "")]
        vecs = []
        for d in dirs:
            d = d.strip().lstrip("(").rstrip(")")
            vecs.append([float(x) for x in d.split(",")])
        spacing = [float(np.linalg.norm(v)) for v in vecs]
    elif "spacings" in header:
        spacing = [float(s) for s in header["spacings"].split()]
    return np.asarray(data), {
        "shape": shape, "spacing_xyz": tuple(spacing),
        "nrrd_header": dict(header),
    }


def write_nrrd(fname: str, data_xyz: np.ndarray, header: dict = None,
               spacing_xyz=None, compressed: bool = True):
    h = dict((header or {}).get("nrrd_header", {}))
    inv = {np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
           np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
           np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
           np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
           np.dtype(np.float32): "float", np.dtype(np.float64): "double"}
    dt = np.dtype(data_xyz.dtype)
    if dt not in inv:
        data_xyz = data_xyz.astype(np.float32)
        dt = data_xyz.dtype
    lines = ["NRRD0004",
             f"type: {inv[np.dtype(dt)]}",
             f"dimension: {data_xyz.ndim}",
             f"sizes: {' '.join(str(s) for s in data_xyz.shape)}",
             f"encoding: {'gzip' if compressed else 'raw'}",
             "endian: little"]
    if "space" in h:
        lines.append(f"space: {h['space']}")
    if "space directions" in h:
        lines.append(f"space directions: {h['space directions']}")
    elif spacing_xyz is not None:
        vecs = []
        for i, s in enumerate(spacing_xyz):
            v = [0.0] * data_xyz.ndim
            v[i] = float(s)
            vecs.append("(" + ",".join(str(x) for x in v) + ")")
        lines.append(f"space directions: {' '.join(vecs)}")
    if "space origin" in h:
        lines.append(f"space origin: {h['space origin']}")
    body = np.asfortranarray(data_xyz).tobytes(order="F")
    if compressed:
        body = gzip.compress(body)
    with open(fname, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("latin-1"))
        f.write(body)


class MetaImageIO(BaseReaderWriter):
    """Reader/writer for .mha / .nrrd (reference: these ride SimpleITKIO)."""

    supported_file_endings = [".mha", ".nrrd"]

    @staticmethod
    def _read_one(f: str):
        if f.endswith(".mha"):
            return read_mha(f)
        return read_nrrd(f)

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings, headers = [], [], []
        for f in image_fnames:
            data, h = self._read_one(f)
            if data.ndim == 2:
                data = data[..., None]
            if data.ndim != 3:
                raise RuntimeError(f"only 3D volumes supported, got {data.shape} in {f}")
            images.append(np.ascontiguousarray(data.transpose(2, 1, 0)).astype(np.float32))
            spacings.append(list(h["spacing_xyz"][::-1]))
            headers.append(h)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image channel shapes differ ({image_fnames})")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"image channel spacings differ: {spacings}")
        props = {"spacing": spacings[0], **headers[0]}
        props["source_ending"] = ".mha" if image_fnames[0].endswith(".mha") else ".nrrd"
        return np.stack(images), props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3
        dtype = np.uint8 if seg.max() < 255 else np.uint16
        data_xyz = seg.astype(dtype).transpose(2, 1, 0)
        sp = properties.get("spacing", [1.0, 1.0, 1.0])[::-1]
        if output_fname.endswith(".mha"):
            write_mha(output_fname, data_xyz, header=properties, spacing_xyz=sp)
        else:
            write_nrrd(output_fname, data_xyz, header=properties, spacing_xyz=sp)

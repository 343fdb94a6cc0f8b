"""MINC2 (.mnc) reader/writer via h5py: the port's own copy of
anatomask_tpu/imageio/minc_io.py (nnU-Net's SimpleITKIO lists .mnc among
its endings). h5py is imported inside the functions. MINC2 files are HDF5
containers:

  /minc-2.0/dimensions/{x,y,z}space   groups with step/start/direction_cosines
  /minc-2.0/image/0/image             voxel dataset, attr 'dimorder'
  /minc-2.0/image/0/image-min|-max    optional per-hyperslab real-value range

Reading: the voxel array (stored in 'dimorder' order, conventionally
zspace,yspace,xspace) is transposed to this framework's (x, y, z) axis order;
integer volumes with image-min/image-max present are rescaled to real values
(valid_range -> [image_min, image_max], broadcast over the leading dims the
min/max arrays span — the common per-z-slice case). Float volumes are taken
as-is. Writing stores segmentation labels unscaled with the original
dimension geometry (step/start/direction_cosines round-trip).
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

from anatomask_torch.imageio.base import BaseReaderWriter

_SPATIAL = ("xspace", "yspace", "zspace")


def read_minc(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        root = f["minc-2.0"]
        img = root["image/0/image"]
        raw = np.asarray(img)
        dimorder = img.attrs.get("dimorder")
        if dimorder is None:
            # No dimorder attr: infer storage order by matching each spatial
            # dimension's 'length' attr against the dataset shape, preferring
            # the conventional MINC2 storage order (zspace, yspace, xspace)
            # among length-compatible permutations; warn that we are guessing.
            import itertools
            import warnings
            names = [n for n in root["dimensions"] if n in _SPATIAL]
            lengths = {n: root[f"dimensions/{n}"].attrs.get("length")
                       for n in names}
            candidates = [p for p in itertools.permutations(names)
                          if len(p) == raw.ndim and all(
                              lengths[n] is None or int(lengths[n]) == s
                              for n, s in zip(p, raw.shape))]
            conventional = tuple(reversed(_SPATIAL))  # zspace, yspace, xspace
            chosen = (conventional if conventional in candidates
                      else (candidates[0] if candidates else conventional))
            warnings.warn(
                f"{path}: MINC2 image has no 'dimorder' attribute; guessing "
                f"storage order {','.join(chosen)} from dimension lengths "
                f"(conventional order is zspace,yspace,xspace).")
            dimorder = ",".join(chosen)
        else:
            if isinstance(dimorder, bytes):
                dimorder = dimorder.decode()
        dims = [d for d in str(dimorder).split(",") if d]
        if len(dims) != raw.ndim or not all(d in _SPATIAL for d in dims):
            raise RuntimeError(
                f"{path}: only 3D spatial MINC volumes are supported "
                f"(dimorder={dims}, shape={raw.shape})")

        # real-value rescale for integer volumes
        if np.issubdtype(raw.dtype, np.integer) and "image/0/image-min" in root:
            imin = np.asarray(root["image/0/image-min"], np.float64)
            imax = np.asarray(root["image/0/image-max"], np.float64)
            vr = img.attrs.get("valid_range")
            if vr is None:
                info = np.iinfo(raw.dtype)
                vr = (info.min, info.max)
            v0, v1 = float(vr[0]), float(vr[1])
            lead = imin.shape  # min/max span the LEADING dims
            shape = lead + (1,) * (raw.ndim - len(lead))
            imin = imin.reshape(shape)
            imax = imax.reshape(shape)
            frac = (raw.astype(np.float64) - v0) / max(v1 - v0, 1e-30)
            raw = (imin + frac * (imax - imin)).astype(np.float32)
        else:
            raw = raw.astype(np.float32)

        dim_meta = {}
        for name in dims:
            g = root[f"dimensions/{name}"]
            dim_meta[name] = {
                "step": float(g.attrs.get("step", 1.0)),
                "start": float(g.attrs.get("start", 0.0)),
                "direction_cosines": [float(v) for v in np.atleast_1d(
                    g.attrs.get("direction_cosines",
                                np.eye(3)[_SPATIAL.index(name)]))],
            }

    # transpose stored order -> (x, y, z)
    perm = [dims.index(n) for n in _SPATIAL]
    data = np.ascontiguousarray(raw.transpose(perm))
    spacing = [abs(dim_meta[n]["step"]) for n in _SPATIAL]
    return data, {"spacing": spacing, "minc_dims": dim_meta}


def write_minc(path: str, data_xyz: np.ndarray, properties: dict):
    import h5py

    dim_meta = properties.get("minc_dims") or {
        n: {"step": properties.get("spacing", [1, 1, 1])[i], "start": 0.0,
            "direction_cosines": list(np.eye(3)[i])}
        for i, n in enumerate(_SPATIAL)
    }
    # store in the conventional zspace,yspace,xspace order
    stored = np.ascontiguousarray(data_xyz.transpose(2, 1, 0))
    with h5py.File(path, "w") as f:
        root = f.create_group("minc-2.0")
        dgrp = root.create_group("dimensions")
        for i, name in enumerate(("zspace", "yspace", "xspace")):
            g = dgrp.create_group(name)
            m = dim_meta.get(name, {})
            g.attrs["step"] = float(m.get("step", 1.0))
            g.attrs["start"] = float(m.get("start", 0.0))
            g.attrs["direction_cosines"] = np.asarray(
                m.get("direction_cosines", np.eye(3)[2 - i]), np.float64)
            g.attrs["length"] = stored.shape[i]
        img = root.create_group("image").create_group("0")
        ds = img.create_dataset("image", data=stored)
        ds.attrs["dimorder"] = "zspace,yspace,xspace"


class MincIO(BaseReaderWriter):
    """MINC2 volumes (.mnc). Spacing in properties is aligned to the returned
    (x, y, z) axes like every other backend."""

    supported_file_endings = [".mnc"]

    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]) -> Tuple[np.ndarray, dict]:
        images, spacings, metas = [], [], []
        for fname in image_fnames:
            data, props = read_minc(fname)
            images.append(data.astype(np.float32))
            spacings.append(props["spacing"])
            metas.append(props)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image channel shapes differ ({image_fnames})")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"image channel spacings differ: {spacings}")
        props = dict(metas[0])
        props["source_ending"] = ".mnc"
        return np.stack(images), props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict) -> None:
        assert seg.ndim == 3
        dtype = np.uint8 if seg.max() < 255 else np.uint16
        write_minc(output_fname, seg.astype(dtype), properties)

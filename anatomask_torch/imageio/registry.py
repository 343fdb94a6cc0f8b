"""Reader/writer registry: the port's own copy of
anatomask_tpu/imageio/registry.py.

Selection by dataset.json 'overwrite_image_reader_writer', else by file
ending, through an explicit registry. nnU-Net's backend names (SimpleITKIO,
NibabelIO, ...) alias to the pure-numpy readers, so nnU-Net dataset.json
and plans files load unchanged.
"""
from __future__ import annotations

from typing import Optional, Type

from anatomask_torch.imageio.base import BaseReaderWriter
from anatomask_torch.imageio.natural_image import NaturalImage2DIO
from anatomask_torch.imageio.meta_image import MetaImageIO
from anatomask_torch.imageio.minc_io import MincIO
from anatomask_torch.imageio.nifti import NiftiIO, NiftiIOWithReorient
from anatomask_torch.imageio.numpy_io import NumpyIO
from anatomask_torch.imageio.tiff_io import Tiff3DIO

class SitkLikeIO(BaseReaderWriter):
    """Alias target for nnU-Net's SimpleITKIO: the reference backend handles
    NIfTI/MetaImage/NRRD/MINC by file ending, so this dispatches each call to
    the matching native backend instead of pinning one format."""

    supported_file_endings = [".nii", ".nii.gz", ".mha", ".nrrd", ".mnc"]

    @staticmethod
    def _impl(fname: str) -> BaseReaderWriter:
        import os
        base = os.path.basename(fname)
        if "." not in base:
            raise RuntimeError(
                f"File '{fname}' has no extension; supported endings: "
                f"{SitkLikeIO.supported_file_endings}")
        return determine_reader_writer_from_file_ending("." + base.split(".", 1)[1])()

    def read_images(self, image_fnames):
        return self._impl(image_fnames[0]).read_images(image_fnames)

    def read_seg(self, seg_fname):
        return self._impl(seg_fname).read_seg(seg_fname)

    def write_seg(self, seg, output_fname, properties):
        return self._impl(output_fname).write_seg(seg, output_fname, properties)


_REGISTRY = {
    "NiftiIO": NiftiIO,
    "NiftiIOWithReorient": NiftiIOWithReorient,
    "NumpyIO": NumpyIO,
    "NaturalImage2DIO": NaturalImage2DIO,
    "Tiff3DIO": Tiff3DIO,
    "MetaImageIO": MetaImageIO,
    "MincIO": MincIO,
    # the planner persists the resolved class NAME into plans.json, so the
    # dispatcher must be findable under its own name too
    "SitkLikeIO": SitkLikeIO,
    # aliases for nnU-Net dataset.json compatibility
    "SimpleITKIO": SitkLikeIO,
    "NibabelIO": NiftiIO,
    "NibabelIOWithReorient": NiftiIOWithReorient,
}

_ENDING_MAP = [
    ([".nii", ".nii.gz"], NiftiIO),
    ([".npy", ".npz"], NumpyIO),
    ([".tif", ".tiff"], Tiff3DIO),
    ([".mha", ".nrrd"], MetaImageIO),
    ([".mnc"], MincIO),
    ([".png", ".bmp", ".jpg", ".jpeg"], NaturalImage2DIO),
]


def register_reader_writer(name: str, cls: Type[BaseReaderWriter]):
    _REGISTRY[name] = cls


def find_reader_writer_by_name(name: str) -> Type[BaseReaderWriter]:
    if name not in _REGISTRY:
        raise RuntimeError(
            f"Unknown reader/writer {name!r}. Registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def determine_reader_writer_from_file_ending(file_ending: str) -> Type[BaseReaderWriter]:
    for endings, cls in _ENDING_MAP:
        if any(file_ending.endswith(e) for e in endings):
            return cls
    raise RuntimeError(f"No reader/writer registered for file ending {file_ending!r}")


def determine_reader_writer_from_dataset_json(
    dataset_json: dict, example_file: Optional[str] = None
) -> Type[BaseReaderWriter]:
    if dataset_json.get("overwrite_image_reader_writer") not in (None, "None"):
        return find_reader_writer_by_name(dataset_json["overwrite_image_reader_writer"])
    ending = dataset_json.get("file_ending")
    if ending is None and example_file is not None:
        ending = "." + example_file.split(".", 1)[1]
    return determine_reader_writer_from_file_ending(ending)

"""Case preprocessing: transpose -> crop -> normalize -> resample -> class
locations. The port's own copy of anatomask_tpu/preprocessing/preprocessor.py
(nnU-Net's DefaultPreprocessor), host numpy with the same arithmetic:
`DefaultPreprocessor` (`run_case_npy`, `run_case`, `run_case_save`, `run`),
`get_preprocessor_class`, and the case properties on disk
(`save_properties`, `load_properties`: JSON + an npz for the arrays; a
nnU-Net .pkl is read too). `run` preprocesses a dataset in spawned worker
processes.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import pickle
from typing import List, Optional, Tuple, Union

import numpy as np

from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import (ConfigurationManager, PlansManager, load_json)
from anatomask_torch.preprocessing.cropping import crop_to_nonzero
from anatomask_torch.preprocessing.normalization import get_normalization_scheme
from anatomask_torch.preprocessing.resampling import compute_new_shape
from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name


class DefaultPreprocessor:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose

    def run_case_npy(
        self,
        data: np.ndarray,
        seg: Optional[np.ndarray],
        properties: dict,
        plans_manager: PlansManager,
        configuration_manager: ConfigurationManager,
        dataset_json: Union[dict, str],
    ) -> Tuple[np.ndarray, np.ndarray]:
        data = np.copy(data)
        if seg is not None:
            assert data.shape[1:] == seg.shape[1:], (
                "Shape mismatch between image and segmentation."
            )
            seg = np.copy(seg)
        has_seg = seg is not None

        # transpose forward (also applies to spacing)
        tf = plans_manager.transpose_forward
        data = data.transpose([0, *[i + 1 for i in tf]])
        if seg is not None:
            seg = seg.transpose([0, *[i + 1 for i in tf]])
        original_spacing = [properties["spacing"][i] for i in tf]

        properties["shape_before_cropping"] = tuple(data.shape[1:])
        data, seg, bbox = crop_to_nonzero(data, seg)
        properties["bbox_used_for_cropping"] = bbox
        properties["shape_after_cropping_and_before_resampling"] = tuple(data.shape[1:])

        target_spacing = list(configuration_manager.spacing)
        if len(target_spacing) < data.ndim - 1:
            # 2d configuration: keep between-slice spacing unchanged
            target_spacing = [original_spacing[0]] + target_spacing
        new_shape = compute_new_shape(data.shape[1:], original_spacing, target_spacing)

        # normalize BEFORE resampling (nonzero mask must still align with the image)
        data = self._normalize(
            data, seg, configuration_manager,
            plans_manager.foreground_intensity_properties_per_channel,
        )

        data = configuration_manager.resampling_fn_data(data, new_shape, original_spacing, target_spacing)
        seg = configuration_manager.resampling_fn_seg(seg, new_shape, original_spacing, target_spacing)

        if has_seg:
            label_manager = plans_manager.get_label_manager(
                dataset_json if isinstance(dataset_json, dict) else load_json(dataset_json)
            )
            collect_for_this = list(
                label_manager.foreground_regions if label_manager.has_regions
                else label_manager.foreground_labels
            )
            # with an ignore label, sampling must stay inside annotated regions:
            # add the union of all real labels as an extra samplable "class"
            if label_manager.has_ignore_label:
                collect_for_this.append(label_manager.all_labels)
            properties["class_locations"] = self._sample_foreground_locations(
                seg, collect_for_this, verbose=self.verbose
            )
            seg = self.modify_seg_fn(seg, plans_manager, dataset_json, configuration_manager)
        seg = seg.astype(np.int16 if np.max(seg) > 127 else np.int8)
        return data, seg

    def modify_seg_fn(self, seg, plans_manager, dataset_json, configuration_manager):
        """Hook for subclasses (e.g. cascade previous-stage seg injection)."""
        return seg

    def run_case(self, image_files: List[str], seg_file: Optional[str],
                 plans_manager: PlansManager, configuration_manager: ConfigurationManager,
                 dataset_json: Union[dict, str]):
        if isinstance(dataset_json, str):
            dataset_json = load_json(dataset_json)
        rw = plans_manager.image_reader_writer_class()
        data, data_properties = rw.read_images(image_files)
        seg = rw.read_seg(seg_file)[0] if seg_file is not None else None
        data, seg = self.run_case_npy(
            data, seg, data_properties, plans_manager, configuration_manager, dataset_json
        )
        return data, seg, data_properties

    def run_case_save(self, output_filename_truncated: str, image_files: List[str],
                      seg_file: Optional[str], plans_manager: PlansManager,
                      configuration_manager: ConfigurationManager,
                      dataset_json: Union[dict, str]):
        data, seg, properties = self.run_case(
            image_files, seg_file, plans_manager, configuration_manager, dataset_json
        )
        np.savez_compressed(output_filename_truncated + ".npz", data=data, seg=seg)
        save_properties(properties, output_filename_truncated)

    @staticmethod
    def _sample_foreground_locations(seg: np.ndarray, classes_or_regions,
                                     seed: int = 1234, verbose: bool = False) -> dict:
        """10k voxel coordinates per class/region (>=1% coverage), fixed seed."""
        num_samples = 10000
        min_percent_coverage = 0.01
        rndst = np.random.RandomState(seed)
        class_locs = {}
        for c in classes_or_regions:
            k = tuple(c) if isinstance(c, list) else c
            if isinstance(c, (tuple, list)):
                mask = np.isin(seg, np.asarray(c))
            else:
                mask = seg == c
            all_locs = np.argwhere(mask)
            if len(all_locs) == 0:
                class_locs[k] = []
                continue
            target = min(num_samples, len(all_locs))
            target = max(target, int(np.ceil(len(all_locs) * min_percent_coverage)))
            class_locs[k] = all_locs[rndst.choice(len(all_locs), target, replace=False)]
            if verbose:
                print(c, target)
        return class_locs

    def _normalize(self, data, seg, configuration_manager, fg_intensity_props: dict) -> np.ndarray:
        for c in range(data.shape[0]):
            scheme = configuration_manager.normalization_schemes[c]
            normalizer = get_normalization_scheme(scheme)(
                use_mask_for_norm=configuration_manager.use_mask_for_norm[c],
                intensityproperties=fg_intensity_props.get(str(c), fg_intensity_props.get(c, {})),
            )
            data[c] = normalizer.run(data[c], seg[0] if seg is not None else None)
        return data

    def run(self, dataset_name_or_id: Union[int, str], configuration_name: str,
            plans_identifier: str = "ATKPlans", num_processes: int = 8):
        """Preprocess a whole dataset into <preprocessed>/<dataset>/<data_identifier>/."""
        dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        pp_dir = os.path.join(require("preprocessed"), dataset_name)
        plans = PlansManager(os.path.join(pp_dir, plans_identifier + ".json"))
        cm = plans.get_configuration(configuration_name)
        dataset_json = load_json(os.path.join(pp_dir, "dataset.json"))

        raw_dir = os.path.join(require("raw"), dataset_name)
        out_dir = os.path.join(pp_dir, cm.data_identifier)
        os.makedirs(out_dir, exist_ok=True)

        from anatomask_torch.utils.helpers import get_case_identifiers_from_raw, get_filenames_of_case
        identifiers = get_case_identifiers_from_raw(raw_dir, dataset_json)
        jobs = []
        for ident in identifiers:
            images, seg = get_filenames_of_case(raw_dir, ident, dataset_json)
            jobs.append((os.path.join(out_dir, ident), images, seg))

        if num_processes <= 1:
            for out_base, images, seg in jobs:
                self.run_case_save(out_base, images, seg, plans, cm, dataset_json)
        else:
            ctx = multiprocessing.get_context("spawn")
            from concurrent.futures import ProcessPoolExecutor, as_completed
            with ProcessPoolExecutor(max_workers=num_processes, mp_context=ctx) as ex:
                futs = [
                    ex.submit(self.run_case_save, out_base, images, seg, plans, cm, dataset_json)
                    for out_base, images, seg in jobs
                ]
                for f in as_completed(futs):
                    f.result()  # surface worker exceptions immediately
        return out_dir


def get_preprocessor_class(name: str):
    registry = {"DefaultPreprocessor": DefaultPreprocessor}
    if name not in registry:
        raise RuntimeError(f"Unknown preprocessor {name!r}. Known: {sorted(registry)}")
    return registry[name]


def save_properties(properties: dict, output_filename_truncated: str):
    """Store case properties as JSON + an npz for array-valued class_locations."""
    props = dict(properties)
    class_locs = props.pop("class_locations", None)
    props.pop("nifti_header", None)
    props.pop("affine", None)
    serializable = {}
    for k, v in props.items():
        if isinstance(v, np.ndarray):
            v = v.tolist()
        serializable[k] = v
    arrays = {}
    if "nifti_header" in properties:
        arrays["nifti_header"] = np.frombuffer(properties["nifti_header"], dtype=np.uint8)
    if "affine" in properties:
        arrays["affine"] = np.asarray(properties["affine"])
    if class_locs is not None:
        keys = []
        for i, (k, v) in enumerate(class_locs.items()):
            keys.append(repr(k))
            arrays[f"class_loc_{i}"] = np.asarray(v, dtype=np.int32)
        serializable["__class_location_keys__"] = keys
    with open(output_filename_truncated + ".props.json", "w") as f:
        json.dump(serializable, f)
    if arrays:
        np.savez_compressed(output_filename_truncated + ".props.npz", **arrays)


def load_properties(output_filename_truncated: str) -> dict:
    """Load properties written by save_properties, or a reference .pkl file."""
    jpath = output_filename_truncated + ".props.json"
    if not os.path.isfile(jpath):
        # fall back to nnU-Net reference pickle format
        with open(output_filename_truncated + ".pkl", "rb") as f:
            return pickle.load(f)
    with open(jpath) as f:
        props = json.load(f)
    npz_path = output_filename_truncated + ".props.npz"
    if os.path.isfile(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            if "nifti_header" in z:
                props["nifti_header"] = z["nifti_header"].tobytes()
            if "affine" in z:
                props["affine"] = z["affine"]
            keys = props.pop("__class_location_keys__", None)
            if keys is not None:
                from ast import literal_eval
                props["class_locations"] = {
                    literal_eval(k): z[f"class_loc_{i}"] for i, k in enumerate(keys)
                }
    return props

"""Rule-based experiment planner. The port's own copy of
anatomask_tpu/planning/planner.py (nnU-Net's default_experiment_planner.py
and resencUNet_planner.py), host numpy with the same arithmetic, so that both
packages plan a dataset alike.

Transpose by spacing, median target spacing with the 10th-percentile
anisotropy override, normalization scheme and use-mask-if-cropped < 3/4,
a patch from 1/spacing scaled to a 256^3 voxel budget, the topology of
`planning/topology.py`, the memory-estimate patch-shrink loop, the batch
size from the headroom capped at 5% of the dataset's voxels, a 3d_lowres
configuration (spacing grown by 1.03 a step) with its cascade where the
patch covers under a quarter of the median image, and a 2d configuration.

The memory proxy is the sum of conv output feature-map voxels over the
U-Net; the reference constants (560e6 for 8 GB at batch 2 in 3D) and the
default memory_target_gb=8.0 are kept, so that patch and batch decisions
are nnU-Net's on the same dataset. A larger card's user raises
memory_target_gb (the command line's -gpu_memory_target).
"""
from __future__ import annotations

import os
import shutil
from copy import deepcopy
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from anatomask_torch.configuration import ANISO_THRESHOLD
from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import load_json, save_json
from anatomask_torch.planning.fingerprint import DatasetFingerprintExtractor
from anatomask_torch.planning.topology import get_pool_and_conv_props
from anatomask_torch.preprocessing.normalization import channel_name_to_normalization_scheme, get_normalization_scheme
from anatomask_torch.preprocessing.resampling import compute_new_shape
from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name


def estimate_conv_feature_map_voxels(
    patch_size: Sequence[int],
    n_stages: int,
    strides: Sequence[Sequence[int]],
    num_input_channels: int,
    features_per_stage: Sequence[int],
    blocks_per_stage_encoder: Sequence[int],
    blocks_per_stage_decoder: Sequence[int],
    num_classes: int,
) -> int:
    """Total conv-output featuremap voxels for a plain conv U-Net (memory proxy)."""
    total = np.int64(0)
    size = list(patch_size)
    skip_sizes: List[List[int]] = []
    for s in range(n_stages):
        size = [i // j for i, j in zip(size, strides[s])]
        skip_sizes.append(list(size))
        total += np.int64(blocks_per_stage_encoder[s]) * features_per_stage[s] * np.prod(size, dtype=np.int64)
    # decoder: n_stages-1 upsampling stages, working from the bottleneck upward
    for s in range(n_stages - 1):
        tgt = skip_sizes[-(s + 2)]
        f = features_per_stage[-(s + 2)]
        vox = np.prod(tgt, dtype=np.int64)
        total += f * vox  # transpconv output
        total += np.int64(blocks_per_stage_decoder[s]) * f * vox  # conv stack
        total += np.int64(num_classes) * vox  # (deep supervision) seg head
    return int(total)


class ExperimentPlanner:
    def __init__(
        self,
        dataset_name_or_id: Union[str, int],
        memory_target_gb: float = 8.0,
        preprocessor_name: str = "DefaultPreprocessor",
        plans_name: str = "ATKPlans",
        overwrite_target_spacing: Optional[List[float]] = None,
        suppress_transpose: bool = False,
    ):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.raw_dataset_folder = os.path.join(require("raw"), self.dataset_name)
        self.dataset_json = load_json(os.path.join(self.raw_dataset_folder, "dataset.json"))
        fp_file = os.path.join(require("preprocessed"), self.dataset_name, "dataset_fingerprint.json")
        if not os.path.isfile(fp_file):
            raise RuntimeError(
                f"Fingerprint missing for {self.dataset_name}; run DatasetFingerprintExtractor first"
            )
        self.dataset_fingerprint = load_json(fp_file)
        self.plans_identifier = plans_name
        self.preprocessor_name = preprocessor_name
        self.overwrite_target_spacing = overwrite_target_spacing
        self.suppress_transpose = suppress_transpose
        self.anisotropy_threshold = ANISO_THRESHOLD
        self.lowres_creation_threshold = 0.25  # patch covers <25% of median shape -> make lowres

        # memory-model constants (nnU-Net's, so that decisions are its own)
        self.UNet_base_num_features = 32
        self.UNet_reference_val_3d = 560_000_000
        self.UNet_reference_val_2d = 85_000_000
        self.UNet_reference_com_nfeatures = 32
        self.UNet_reference_val_corresp_GB = 8
        self.UNet_reference_val_corresp_bs_2d = 12
        self.UNet_reference_val_corresp_bs_3d = 2
        self.UNet_memory_target_GB = memory_target_gb
        self.UNet_featuremap_min_edge_length = 4
        self.UNet_blocks_per_stage_encoder = (2,) * 14
        self.UNet_blocks_per_stage_decoder = (2,) * 13
        self.UNet_min_batch_size = 2
        self.UNet_max_features_2d = 512
        self.UNet_max_features_3d = 320
        self.UNet_class_name = "PlainConvUNet"
        self.plans = None

    # --- sub-decisions --------------------------------------------------------
    def determine_reader_writer(self):
        example = None
        images_dir = os.path.join(self.raw_dataset_folder, "imagesTr")
        if os.path.isdir(images_dir):
            files = sorted(os.listdir(images_dir))
            example = os.path.join(images_dir, files[0]) if files else None
        return determine_reader_writer_from_dataset_json(self.dataset_json, example)

    def determine_fullres_target_spacing(self) -> np.ndarray:
        if self.overwrite_target_spacing is not None:
            return np.array(self.overwrite_target_spacing)
        spacings = np.vstack(self.dataset_fingerprint["spacings"])
        sizes = np.vstack(self.dataset_fingerprint["shapes_after_crop"])
        target = np.percentile(spacings, 50, 0)
        target_size = np.percentile(sizes, 50, 0)
        worst = int(np.argmax(target))
        others = [i for i in range(len(target)) if i != worst]
        other_spacings = [target[i] for i in others]
        other_sizes = [target_size[i] for i in others]
        has_aniso_spacing = target[worst] > self.anisotropy_threshold * max(other_spacings)
        has_aniso_voxels = target_size[worst] * self.anisotropy_threshold < min(other_sizes)
        if has_aniso_spacing and has_aniso_voxels:
            t = np.percentile(spacings[:, worst], 10)
            if t < max(other_spacings):
                t = max(max(other_spacings), t) + 1e-5
            target[worst] = t
        return target

    def determine_normalization(self) -> Tuple[List[str], List[bool]]:
        modalities = self.dataset_json.get("channel_names", self.dataset_json.get("modality"))
        schemes = [channel_name_to_normalization_scheme(m) for m in modalities.values()]
        if self.dataset_fingerprint["median_relative_size_after_cropping"] < 3 / 4:
            use_mask = [
                bool(get_normalization_scheme(s).leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true)
                for s in schemes
            ]
        else:
            use_mask = [False] * len(schemes)
        return schemes, use_mask

    def determine_transpose(self) -> Tuple[List[int], List[int]]:
        if self.suppress_transpose:
            return [0, 1, 2], [0, 1, 2]
        target_spacing = self.determine_fullres_target_spacing()
        max_axis = int(np.argmax(target_spacing))
        remaining = [i for i in range(3) if i != max_axis]
        forward = [max_axis] + remaining
        backward = [forward.index(i) for i in range(3)]
        return forward, backward

    def determine_resampling(self):
        data_kwargs = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
        seg_kwargs = {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None}
        return "resample_data_or_seg_to_shape", data_kwargs, "resample_data_or_seg_to_shape", seg_kwargs

    def determine_segmentation_softmax_export_fn(self):
        return "resample_data_or_seg_to_shape", {
            "is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None,
        }

    def _estimate(self, patch_size, pool_op_kernel_sizes) -> int:
        num_stages = len(pool_op_kernel_sizes)
        dim = len(patch_size)
        max_feat = self.UNet_max_features_2d if dim == 2 else self.UNet_max_features_3d
        features = [min(max_feat, self.UNet_reference_com_nfeatures * 2 ** i) for i in range(num_stages)]
        n_channels = len(self.dataset_json.get("channel_names", self.dataset_json.get("modality")))
        return estimate_conv_feature_map_voxels(
            patch_size, num_stages, pool_op_kernel_sizes, n_channels, features,
            self.UNet_blocks_per_stage_encoder[:num_stages],
            self.UNet_blocks_per_stage_decoder[: num_stages - 1],
            len(self.dataset_json["labels"]),
        )

    # --- per-configuration planning -------------------------------------------
    def get_plans_for_configuration(self, spacing, median_shape, data_identifier: str,
                                    approximate_n_voxels_dataset: float) -> dict:
        spacing = np.asarray(spacing, dtype=float)
        assert np.all(spacing > 0), f"Spacing must be > 0, got {spacing}"
        dim = len(spacing)
        tmp = 1 / spacing
        if dim == 3:
            initial_patch_size = [round(i) for i in tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3)]
        elif dim == 2:
            initial_patch_size = [round(i) for i in tmp * (2048 ** 2 / np.prod(tmp)) ** (1 / 2)]
        else:
            raise RuntimeError(f"unsupported dimensionality {dim}")
        initial_patch_size = np.array(
            [min(i, j) for i, j in zip(initial_patch_size, median_shape[:dim])]
        )

        num_pool_per_axis, pool_sizes, conv_sizes, patch_size, must_div = get_pool_and_conv_props(
            spacing, initial_patch_size, self.UNet_featuremap_min_edge_length, 999999
        )
        estimate = self._estimate(patch_size, pool_sizes)
        reference = (self.UNet_reference_val_2d if dim == 2 else self.UNet_reference_val_3d) * (
            self.UNet_memory_target_GB / self.UNet_reference_val_corresp_GB
        )

        while estimate > reference:
            # shrink the axis most oversized relative to the median shape;
            # step down past the current divisibility constraint without skipping
            # valid intermediate sizes (recompute divisibility at the reduced size)
            axis = int(np.argsort(np.asarray(patch_size) / np.asarray(median_shape[:dim]))[-1])
            tmp_ps = deepcopy(patch_size)
            tmp_ps[axis] -= must_div[axis]
            _, _, _, _, must_div_new = get_pool_and_conv_props(
                spacing, tmp_ps, self.UNet_featuremap_min_edge_length, 999999
            )
            patch_size[axis] -= must_div_new[axis]
            num_pool_per_axis, pool_sizes, conv_sizes, patch_size, must_div = get_pool_and_conv_props(
                spacing, patch_size, self.UNet_featuremap_min_edge_length, 999999
            )
            estimate = self._estimate(patch_size, pool_sizes)

        ref_bs = self.UNet_reference_val_corresp_bs_2d if dim == 2 else self.UNet_reference_val_corresp_bs_3d
        batch_size = round((reference / estimate) * ref_bs)
        bs_5pct = round(approximate_n_voxels_dataset * 0.05 / np.prod(patch_size, dtype=np.float64))
        batch_size = max(min(batch_size, bs_5pct), self.UNet_min_batch_size)

        fn_data, kw_data, fn_seg, kw_seg = self.determine_resampling()
        fn_probs, kw_probs = self.determine_segmentation_softmax_export_fn()
        schemes, use_mask = self.determine_normalization()
        num_stages = len(pool_sizes)
        return {
            "data_identifier": data_identifier,
            "preprocessor_name": self.preprocessor_name,
            "batch_size": int(batch_size),
            "patch_size": [int(i) for i in patch_size],
            "median_image_size_in_voxels": [int(round(i)) for i in median_shape],
            "spacing": [float(i) for i in spacing],
            "normalization_schemes": schemes,
            "use_mask_for_norm": use_mask,
            "UNet_class_name": self.UNet_class_name,
            "UNet_base_num_features": self.UNet_base_num_features,
            "n_conv_per_stage_encoder": list(self.UNet_blocks_per_stage_encoder[:num_stages]),
            "n_conv_per_stage_decoder": list(self.UNet_blocks_per_stage_decoder[: num_stages - 1]),
            "num_pool_per_axis": [int(i) for i in num_pool_per_axis],
            "pool_op_kernel_sizes": [list(map(int, p)) for p in pool_sizes],
            "conv_kernel_sizes": [list(map(int, c)) for c in conv_sizes],
            "unet_max_num_features": self.UNet_max_features_3d if dim == 3 else self.UNet_max_features_2d,
            "resampling_fn_data": fn_data,
            "resampling_fn_seg": fn_seg,
            "resampling_fn_data_kwargs": kw_data,
            "resampling_fn_seg_kwargs": kw_seg,
            "resampling_fn_probabilities": fn_probs,
            "resampling_fn_probabilities_kwargs": kw_probs,
        }

    # --- whole-experiment planning --------------------------------------------
    def plan_experiment(self) -> dict:
        transpose_forward, transpose_backward = self.determine_transpose()
        fullres_spacing = self.determine_fullres_target_spacing()
        fullres_spacing_t = fullres_spacing[transpose_forward]

        new_shapes = [
            compute_new_shape(shape, sp, fullres_spacing)
            for sp, shape in zip(
                self.dataset_fingerprint["spacings"], self.dataset_fingerprint["shapes_after_crop"]
            )
        ]
        new_median_shape = np.median(new_shapes, 0)
        new_median_shape_t = new_median_shape[transpose_forward]
        n_train = self.dataset_json["numTraining"]
        approx_voxels = float(np.prod(new_median_shape_t, dtype=np.float64) * n_train)

        plan_3d_fullres = plan_3d_lowres = None
        if new_median_shape_t[0] != 1:
            plan_3d_fullres = self.get_plans_for_configuration(
                fullres_spacing_t, new_median_shape_t,
                self.generate_data_identifier("3d_fullres"), approx_voxels,
            )
            # grow spacing until the lowres patch covers enough of the median image
            patch = plan_3d_fullres["patch_size"]
            median_num_voxels = np.prod(new_median_shape_t, dtype=np.float64)
            num_voxels_in_patch = np.prod(patch, dtype=np.float64)
            lowres_spacing = np.array(plan_3d_fullres["spacing"], dtype=float)
            while num_voxels_in_patch / median_num_voxels < self.lowres_creation_threshold:
                max_sp = max(lowres_spacing)
                if np.any((max_sp / lowres_spacing) > 2):
                    lowres_spacing[(max_sp / lowres_spacing) > 2] *= 1.03
                else:
                    lowres_spacing *= 1.03
                median_num_voxels = np.prod(
                    np.array(plan_3d_fullres["spacing"]) / lowres_spacing * new_median_shape_t,
                    dtype=np.float64,
                )
                plan_3d_lowres = self.get_plans_for_configuration(
                    lowres_spacing,
                    [round(i) for i in np.array(plan_3d_fullres["spacing"]) / lowres_spacing * new_median_shape_t],
                    self.generate_data_identifier("3d_lowres"),
                    float(median_num_voxels * n_train),
                )
                num_voxels_in_patch = np.prod(plan_3d_lowres["patch_size"], dtype=np.int64)
            if plan_3d_lowres is not None:
                plan_3d_lowres["batch_dice"] = False
                plan_3d_fullres["batch_dice"] = True
            else:
                plan_3d_fullres["batch_dice"] = False

        plan_2d = self.get_plans_for_configuration(
            fullres_spacing_t[1:], new_median_shape_t[1:],
            self.generate_data_identifier("2d"), approx_voxels,
        )
        plan_2d["batch_dice"] = True

        median_spacing = np.median(self.dataset_fingerprint["spacings"], 0)[transpose_forward]
        median_shape = np.median(self.dataset_fingerprint["shapes_after_crop"], 0)[transpose_forward]

        pp_dir = os.path.join(require("preprocessed"), self.dataset_name)
        os.makedirs(pp_dir, exist_ok=True)
        shutil.copy(
            os.path.join(self.raw_dataset_folder, "dataset.json"),
            os.path.join(pp_dir, "dataset.json"),
        )

        plans = {
            "dataset_name": self.dataset_name,
            "plans_name": self.plans_identifier,
            "original_median_spacing_after_transp": [float(i) for i in median_spacing],
            "original_median_shape_after_transp": [int(round(i)) for i in median_shape],
            "image_reader_writer": self.determine_reader_writer().__name__,
            "transpose_forward": [int(i) for i in transpose_forward],
            "transpose_backward": [int(i) for i in transpose_backward],
            "configurations": {"2d": plan_2d},
            "experiment_planner_used": type(self).__name__,
            "label_manager": "LabelManager",
            "foreground_intensity_properties_per_channel": self.dataset_fingerprint[
                "foreground_intensity_properties_per_channel"
            ],
        }
        if plan_3d_lowres is not None:
            plans["configurations"]["3d_lowres"] = plan_3d_lowres
            if plan_3d_fullres is not None:
                plan_3d_lowres["next_stage"] = "3d_cascade_fullres"
        if plan_3d_fullres is not None:
            plans["configurations"]["3d_fullres"] = plan_3d_fullres
            if plan_3d_lowres is not None:
                plans["configurations"]["3d_cascade_fullres"] = {
                    "inherits_from": "3d_fullres",
                    "previous_stage": "3d_lowres",
                }

        self.plans = plans
        self.save_plans(plans)
        return plans

    def save_plans(self, plans: dict):
        plans_file = os.path.join(require("preprocessed"), self.dataset_name, self.plans_identifier + ".json")
        # keep user-added custom configurations from an existing plans file
        if os.path.isfile(plans_file):
            old = load_json(plans_file)["configurations"]
            for c in plans["configurations"]:
                old.pop(c, None)
            plans["configurations"].update(old)
        os.makedirs(os.path.dirname(plans_file), exist_ok=True)
        save_json(plans, plans_file, sort_keys=False)

    def generate_data_identifier(self, configuration_name: str) -> str:
        return f"{self.plans_identifier}_{configuration_name}"


def plan_and_preprocess(dataset_name_or_id, configurations=("3d_fullres",),
                        plans_name: str = "ATKPlans", num_processes: int = 8,
                        memory_target_gb: float = 8.0, overwrite: bool = False) -> dict:
    """Fingerprint -> plan -> preprocess, nnU-Net's plan_and_preprocess in
    one call."""
    DatasetFingerprintExtractor(dataset_name_or_id, num_processes).run(overwrite_existing=overwrite)
    planner = ExperimentPlanner(dataset_name_or_id, memory_target_gb=memory_target_gb, plans_name=plans_name)
    plans = planner.plan_experiment()
    from anatomask_torch.preprocessing.preprocessor import DefaultPreprocessor
    for config in configurations:
        if config not in plans["configurations"]:
            continue
        pp = DefaultPreprocessor()
        pp.run(dataset_name_or_id, config, plans_name, num_processes)
    return plans


class ResEncUNetPlanner(ExperimentPlanner):
    """The residual-encoder U-Net planner: the same pipeline with
    ResidualEncoderUNet, its memory-reference constants and deeper encoder
    block counts (1, 3, 4, 6, 6, ...)."""

    def __init__(self, dataset_name_or_id, memory_target_gb: float = 8.0,
                 preprocessor_name: str = "DefaultPreprocessor",
                 plans_name: str = "ATKResEncUNetPlans",
                 overwrite_target_spacing=None, suppress_transpose: bool = False):
        super().__init__(dataset_name_or_id, memory_target_gb, preprocessor_name,
                         plans_name, overwrite_target_spacing, suppress_transpose)
        self.UNet_class_name = "ResidualEncoderUNet"
        self.UNet_reference_val_3d = 680_000_000
        self.UNet_reference_val_2d = 135_000_000
        self.UNet_blocks_per_stage_encoder = (1, 3, 4, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6)
        self.UNet_blocks_per_stage_decoder = (1,) * 12

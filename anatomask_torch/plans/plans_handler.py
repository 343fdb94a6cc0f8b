"""Plans file management: the port's own copy of
anatomask_tpu/plans/plans_handler.py (PlansManager, ConfigurationManager).

Configuration inheritance via 'inherits_from' with cycle detection and the
per-configuration hyperparameters, as there. Plans files written by nnU-Net
v2 or the JAX package load unchanged. The preprocessor, the resampling
functions (bound to their plans kwargs) and the image reader/writer are
looked up by name in the port's registries, at first use.
"""
from __future__ import annotations

import json
import os
import socket
from copy import deepcopy
from functools import partial
from typing import List, Optional, Union


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save_json(obj, path: str, sort_keys: bool = True):
    """Written under a name of this host and process, then renamed: a reader
    on any node (another rank reading splits_final.json) sees no file or
    the whole one."""
    tmp = f"{path}.{socket.gethostname()}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, sort_keys=sort_keys, indent=4)
    os.replace(tmp, path)


class ConfigurationManager:
    """A single resolved configuration (e.g. '3d_fullres') from a plans file."""

    def __init__(self, configuration_dict: dict):
        self.configuration = configuration_dict

    def __repr__(self):
        return repr(self.configuration)

    # --- core hyperparameters -------------------------------------------------
    @property
    def data_identifier(self) -> str:
        return self.configuration["data_identifier"]

    @property
    def preprocessor_name(self) -> str:
        return self.configuration["preprocessor_name"]

    @property
    def preprocessor_class(self):
        from anatomask_torch.preprocessing.preprocessor import get_preprocessor_class
        return get_preprocessor_class(self.preprocessor_name)

    @property
    def batch_size(self) -> int:
        return self.configuration["batch_size"]

    @property
    def patch_size(self) -> List[int]:
        return self.configuration["patch_size"]

    @property
    def median_image_size_in_voxels(self) -> List[int]:
        return self.configuration["median_image_size_in_voxels"]

    @property
    def spacing(self) -> List[float]:
        return self.configuration["spacing"]

    @property
    def normalization_schemes(self) -> List[str]:
        return self.configuration["normalization_schemes"]

    @property
    def use_mask_for_norm(self) -> List[bool]:
        return self.configuration["use_mask_for_norm"]

    # --- network topology -----------------------------------------------------
    @property
    def network_arch_name(self) -> str:
        # nnU-Net's key: 'UNet_class_name'
        return self.configuration.get("network_arch_name", self.configuration.get("UNet_class_name", "PlainConvUNet"))

    @property
    def UNet_class_name(self) -> str:
        return self.network_arch_name

    @property
    def UNet_base_num_features(self) -> int:
        return self.configuration["UNet_base_num_features"]

    @property
    def n_conv_per_stage_encoder(self) -> List[int]:
        return self.configuration["n_conv_per_stage_encoder"]

    @property
    def n_conv_per_stage_decoder(self) -> List[int]:
        return self.configuration["n_conv_per_stage_decoder"]

    @property
    def num_pool_per_axis(self) -> List[int]:
        return self.configuration["num_pool_per_axis"]

    @property
    def pool_op_kernel_sizes(self) -> List[List[int]]:
        return self.configuration["pool_op_kernel_sizes"]

    @property
    def conv_kernel_sizes(self) -> List[List[int]]:
        return self.configuration["conv_kernel_sizes"]

    @property
    def unet_max_num_features(self) -> int:
        return self.configuration["unet_max_num_features"]

    @property
    def num_stages(self) -> int:
        return len(self.conv_kernel_sizes)

    # --- resampling -----------------------------------------------------------
    def _resampling_fn(self, which: str):
        from anatomask_torch.preprocessing.resampling import get_resampling_fn
        fn = get_resampling_fn(self.configuration[f"resampling_fn_{which}"])
        return partial(fn, **self.configuration.get(f"resampling_fn_{which}_kwargs", {}))

    @property
    def resampling_fn_data(self):
        return self._resampling_fn("data")

    @property
    def resampling_fn_seg(self):
        return self._resampling_fn("seg")

    @property
    def resampling_fn_probabilities(self):
        return self._resampling_fn("probabilities")

    # --- training -------------------------------------------------------------
    @property
    def batch_dice(self) -> bool:
        return self.configuration["batch_dice"]

    # --- cascade --------------------------------------------------------------
    @property
    def next_stage_names(self) -> Optional[List[str]]:
        ret = self.configuration.get("next_stage")
        if ret is not None and isinstance(ret, str):
            ret = [ret]
        return ret

    @property
    def previous_stage_name(self) -> Optional[str]:
        return self.configuration.get("previous_stage")


class PlansManager:
    """Loads a plans file/dict and resolves configuration inheritance.

    Reference behavior reproduced: 'inherits_from' chains resolved depth-first
    with circular-dependency detection; configurations cached.
    """

    def __init__(self, plans_file_or_dict: Union[str, dict]):
        self.plans = (
            plans_file_or_dict
            if isinstance(plans_file_or_dict, dict)
            else load_json(plans_file_or_dict)
        )
        self._config_cache: dict = {}

    def __repr__(self):
        return repr(self.plans)

    def _resolve_inheritance(self, name: str, visited: tuple = ()) -> dict:
        configs = self.plans["configurations"]
        if name not in configs:
            raise ValueError(
                f"Configuration {name!r} does not exist in plans. "
                f"Valid names: {list(configs.keys())}"
            )
        configuration = deepcopy(configs[name])
        parent = configuration.get("inherits_from")
        if parent is not None:
            if parent in visited:
                raise RuntimeError(
                    f"Circular configuration inheritance detected while resolving "
                    f"{name!r}: visited {visited}, parent {parent!r}"
                )
            base = self._resolve_inheritance(parent, (*visited, name))
            base.update(configuration)
            configuration = base
        return configuration

    def get_configuration(self, configuration_name: str) -> ConfigurationManager:
        if configuration_name not in self._config_cache:
            self._config_cache[configuration_name] = ConfigurationManager(
                self._resolve_inheritance(configuration_name)
            )
        return self._config_cache[configuration_name]

    @property
    def dataset_name(self) -> str:
        return self.plans["dataset_name"]

    @property
    def plans_name(self) -> str:
        return self.plans["plans_name"]

    @property
    def original_median_spacing_after_transp(self) -> List[float]:
        return self.plans["original_median_spacing_after_transp"]

    @property
    def original_median_shape_after_transp(self) -> List[float]:
        return self.plans["original_median_shape_after_transp"]

    @property
    def image_reader_writer_class(self):
        from anatomask_torch.imageio.registry import find_reader_writer_by_name
        return find_reader_writer_by_name(self.plans["image_reader_writer"])

    @property
    def transpose_forward(self) -> List[int]:
        return self.plans["transpose_forward"]

    @property
    def transpose_backward(self) -> List[int]:
        return self.plans["transpose_backward"]

    @property
    def available_configurations(self) -> List[str]:
        return list(self.plans["configurations"].keys())

    @property
    def experiment_planner_name(self) -> str:
        return self.plans["experiment_planner_used"]

    def get_label_manager(self, dataset_json: dict, **kwargs):
        from anatomask_torch.plans.label_handling import LabelManager
        return LabelManager(
            label_dict=dataset_json["labels"],
            regions_class_order=dataset_json.get("regions_class_order"),
            **kwargs,
        )

    @property
    def foreground_intensity_properties_per_channel(self) -> dict:
        plans = self.plans
        if "foreground_intensity_properties_per_channel" not in plans:
            if "foreground_intensity_properties_by_modality" in plans:
                return plans["foreground_intensity_properties_by_modality"]
        return plans["foreground_intensity_properties_per_channel"]

"""Predictor: load trained fold(s) and run Gaussian sliding-window inference
with mirror TTA and fold ensembling. Counterpart of
anatomask_tpu/inference/predictor.py (`initialize_from_trained_model_folder`,
`auto_detect_available_folds`, `manual_initialization`,
`predict_sliding_window_return_logits`).

It reads the JAX package's training output as it is: `plans.json`,
`dataset.json` and `fold_{f}/checkpoint_final.npz`, whose STUNet weights
`convert.stunet_state_dict_from_jax` carries into the port's network.
Prediction from raw files (preprocessing, image I/O, export) is not ported
yet (ROADMAP.md).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from anatomask_torch.convert import stunet_state_dict_from_jax
from anatomask_torch.device import resolve_device
from anatomask_torch.inference.sliding_window import (make_tile_predictor,
                                                      sliding_window_predict,
                                                      sliding_window_predict_device_resident)
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.plans.label_handling import determine_num_input_channels
from anatomask_torch.plans.plans_handler import PlansManager, load_json
from anatomask_torch.training.checkpoint import load_checkpoint

# volume + logits + weights (fp32) that may live on the device at once; larger
# volumes stream their tiles from the host
DEVICE_RESIDENT_BUDGET_BYTES = 4 << 30


class Predictor:
    def __init__(self, tile_step_size: float = 0.5, use_gaussian: bool = True,
                 use_mirroring: bool = True, tile_batch_size: int = 2,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.tile_step_size = tile_step_size
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.tile_batch_size = tile_batch_size
        self.dtype = dtype
        self.device = resolve_device(device)

        self.plans_manager: Optional[PlansManager] = None
        self.configuration_manager = None
        self.dataset_json: Optional[dict] = None
        self.network: Optional[torch.nn.Module] = None
        self.list_of_parameters: List[Dict[str, torch.Tensor]] = []
        self.allowed_mirroring_axes: Optional[Sequence[int]] = None
        self.label_manager = None
        self._tile_fn = None

    def initialize_from_trained_model_folder(
            self, model_training_output_dir: str,
            use_folds: Union[Sequence[Union[int, str]], None] = None,
            checkpoint_name: str = "checkpoint_final.npz"):
        if use_folds is None:
            use_folds = self.auto_detect_available_folds(model_training_output_dir,
                                                         checkpoint_name)
        dataset_json = load_json(os.path.join(model_training_output_dir, "dataset.json"))
        plans_manager = PlansManager(os.path.join(model_training_output_dir, "plans.json"))

        weights = []
        configuration_name = mirror_axes = arch_name = None
        for f in use_folds:
            fdir = os.path.join(model_training_output_dir,
                                f"fold_{f}" if f != "all" else "fold_all")
            arrays, meta = load_checkpoint(os.path.join(fdir, checkpoint_name))
            weights.append(arrays["network_weights"])
            configuration_name = meta.get("configuration_name", configuration_name)
            mirror_axes = meta.get("inference_allowed_mirroring_axes", mirror_axes)
            arch_name = meta.get("network_arch_name", arch_name)

        configuration_manager = plans_manager.get_configuration(
            configuration_name or "3d_fullres")
        num_input_channels = determine_num_input_channels(plans_manager, configuration_manager,
                                                          dataset_json)
        label_manager = plans_manager.get_label_manager(dataset_json)
        network = build_network_from_plans(
            plans_manager, configuration_manager, num_input_channels,
            label_manager.num_segmentation_heads, arch_name=arch_name,
            deep_supervision=False, dtype=self.dtype, device=self.device)
        parameters = [stunet_state_dict_from_jax(w) for w in weights]
        self.manual_initialization(network, plans_manager, configuration_manager, parameters,
                                   dataset_json, mirror_axes)

    @staticmethod
    def auto_detect_available_folds(model_training_output_dir: str,
                                    checkpoint_name: str) -> List[int]:
        folds = []
        for d in sorted(os.listdir(model_training_output_dir)):
            if d.startswith("fold_") and d != "fold_all" and os.path.isfile(
                    os.path.join(model_training_output_dir, d, checkpoint_name)):
                folds.append(int(d.split("_")[-1]))
        if not folds:
            raise RuntimeError(f"no fold checkpoints found in {model_training_output_dir}")
        return folds

    def manual_initialization(self, network: torch.nn.Module, plans_manager,
                              configuration_manager, parameters, dataset_json,
                              inference_allowed_mirroring_axes):
        """`network` on this predictor's device; `parameters`: one state_dict
        of it per fold."""
        self.network = network.eval()
        self.plans_manager = plans_manager
        self.configuration_manager = configuration_manager
        self.list_of_parameters = list(parameters)
        self.dataset_json = dataset_json
        self.allowed_mirroring_axes = inference_allowed_mirroring_axes
        self.label_manager = plans_manager.get_label_manager(dataset_json)
        mirror_axes = self.allowed_mirroring_axes if self.use_mirroring else None

        def apply_fn(x: torch.Tensor) -> torch.Tensor:
            out = self.network(x.permute(0, 4, 1, 2, 3))
            if isinstance(out, (tuple, list)):
                out = out[0]
            return out.permute(0, 2, 3, 4, 1)

        self._tile_fn = make_tile_predictor(apply_fn, mirror_axes)

    @staticmethod
    def _fits_device_resident(data: np.ndarray, num_out: int, tile_size: Sequence[int],
                              budget_bytes: int = DEVICE_RESIDENT_BUDGET_BYTES) -> bool:
        """The padded volume, the logits and the weights in fp32 fit the budget."""
        vox = int(np.prod([max(int(s), int(t)) for s, t in zip(data.shape[1:], tile_size)]))
        return 4 * vox * (data.shape[0] + num_out + 1) <= budget_bytes

    def predict_sliding_window_return_logits(self, data: np.ndarray) -> np.ndarray:
        """data: (c, x, y, z) preprocessed -> fold-ensemble averaged logits
        (K, x, y, z). Volumes within the budget are device-resident; larger
        ones stream their tiles."""
        num_out = self.label_manager.num_segmentation_heads
        tile_size = self.configuration_manager.patch_size
        predict = (sliding_window_predict_device_resident
                   if self._fits_device_resident(data, num_out, tile_size)
                   else sliding_window_predict)
        logits = None
        for params in self.list_of_parameters:
            self.network.load_state_dict(params)
            pred = predict(data, self._tile_fn, tile_size, num_out,
                           tile_step_size=self.tile_step_size, use_gaussian=self.use_gaussian,
                           tile_batch_size=self.tile_batch_size, device=self.device)
            logits = pred if logits is None else logits + pred
        return logits / len(self.list_of_parameters)

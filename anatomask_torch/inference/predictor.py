"""Predictor: load trained fold(s), preprocess raw images, run Gaussian
sliding-window inference with mirror TTA and fold ensembling on the card,
export segmentations. Counterpart of anatomask_tpu/inference/predictor.py
(`initialize_from_trained_model_folder`, `manual_initialization`,
`predict_sliding_window_return_logits` with its out-of-memory ladder,
`predict_single_npy_array`, `predict_from_files`).

It reads the JAX package's training output as it is: `plans.json`,
`dataset.json` and `fold_{f}/checkpoint_final.npz`, whose weights
`convert.state_dict_from_jax` carries into the port's network by the
checkpoint's `network_arch_name` (STUNet, PlainConvUNet,
ResidualEncoderUNet).

`predict_from_files` preprocesses cases on the host (image I/O, cropping,
normalization, resampling: numpy and scipy) in spawned worker processes, or
threads, at most num_processes_preprocessing + 1 cases ahead; predicts each
on the card; and exports in threads (resampling the logits back,
segmentation, un-crop, write) while the card works on the next case.
Workers never touch CUDA. `case_timings` keeps, per case of the last
call, the host seconds spent waiting for its preprocessing (fetch_wait), in
the sliding window (logits on the host) and in its export.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from anatomask_torch.convert import state_dict_from_jax
from anatomask_torch.device import compute_dtype, resolve_device
from anatomask_torch.inference.export import (
    convert_predicted_logits_to_segmentation_with_correct_shape,
    export_prediction_from_logits)
from anatomask_torch.inference.sliding_window import (is_oom_error, make_tile_predictor,
                                                      sliding_window_predict,
                                                      sliding_window_predict_device_resident)
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.plans.label_handling import (convert_labelmap_to_one_hot,
                                                  determine_num_input_channels)
from anatomask_torch.plans.plans_handler import PlansManager, load_json
from anatomask_torch.training.checkpoint import load_checkpoint
from anatomask_torch.utils.tracing import span

# volume + logits + weights (fp32) that may live on the device at once; larger
# volumes stream their tiles from the host
DEVICE_RESIDENT_BUDGET_BYTES = 4 << 30


def _timed(fn, *args):
    """fn(*args)'s host seconds."""
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def _preprocess_case(pm: PlansManager, cm, dataset_json: dict, image_files, prev_file,
                     cascade_fg_labels, verbose: bool):
    """Read and preprocess one case. For a cascade stage (`cascade_fg_labels`
    given) with a previous stage's segmentation file, that segmentation goes
    through run_case_npy as the case's seg, so that it is transposed, cropped
    and resampled as a segmentation (nnU-Net's file iterator does the same),
    and the one-hot of the seg it returns over those labels is stacked under
    the data. The JAX package stacks the segmentation as it was read
    (ROADMAP.md §3 item 6). Returns the fp32 volume and its properties. Host
    numpy only, so a thread or a spawned worker process (which gets the
    managers pickled) runs it alike."""
    rw = pm.image_reader_writer_class()
    data, props = rw.read_images(image_files)
    seg_prev = rw.read_seg(prev_file)[0] if prev_file and cascade_fg_labels else None
    data_pp, seg_pp = cm.preprocessor_class(verbose=verbose).run_case_npy(
        data, seg_prev, props, pm, cm, dataset_json)
    if seg_prev is not None:
        onehot = convert_labelmap_to_one_hot(seg_pp[0], cascade_fg_labels,
                                             output_dtype=data_pp.dtype)
        data_pp = np.vstack([data_pp, onehot])
    return data_pp, props


class Predictor:
    def __init__(self, tile_step_size: float = 0.5, use_gaussian: bool = True,
                 use_mirroring: bool = True, tile_batch_size: int = 2, verbose: bool = False,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.tile_step_size = tile_step_size
        self.use_gaussian = use_gaussian
        self.use_mirroring = use_mirroring
        self.tile_batch_size = tile_batch_size
        self.verbose = verbose
        self.dtype = compute_dtype(dtype)  # float32: TF32 off in the library ops
        self.device = resolve_device(device)

        self.plans_manager: Optional[PlansManager] = None
        self.configuration_manager = None
        self.dataset_json: Optional[dict] = None
        self.network: Optional[torch.nn.Module] = None
        self.list_of_parameters: List[Dict[str, torch.Tensor]] = []
        self.allowed_mirroring_axes: Optional[Sequence[int]] = None
        self.label_manager = None
        self._configuration_name: Optional[str] = None
        self._tile_fn = None
        self.case_timings: List[Dict[str, float]] = []

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

        self._configuration_name = configuration_name or "3d_fullres"
        configuration_manager = plans_manager.get_configuration(self._configuration_name)
        arch_name = arch_name or configuration_manager.UNet_class_name
        num_input_channels = determine_num_input_channels(plans_manager, configuration_manager,
                                                          dataset_json)
        label_manager = plans_manager.get_label_manager(dataset_json)
        network = build_network_from_plans(
            plans_manager, configuration_manager, num_input_channels,
            label_manager.num_segmentation_heads, arch_name=arch_name,
            deep_supervision=False, dtype=self.dtype, device=self.device)
        parameters = [state_dict_from_jax(arch_name, w) for w in weights]
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
        ones stream their tiles. The budget does not see the tile forward's
        activations, so where the device runs out of memory (is_oom_error)
        the device-resident path retries at tile batch 1, then the volume
        streams (which itself accumulates in host memory if it has to); the
        rung reached sticks for the remaining folds. Any other error raises."""
        with span("predict.case"):
            num_out = self.label_manager.num_segmentation_heads
            tile_size = self.configuration_manager.patch_size
            device_resident = self._fits_device_resident(data, num_out, tile_size)
            tile_batches = sorted({self.tile_batch_size, 1}, reverse=True)
            kw = dict(tile_step_size=self.tile_step_size, use_gaussian=self.use_gaussian,
                      device=self.device)
            logits = None
            for params in self.list_of_parameters:
                with span("predict.load_weights"):
                    self.network.load_state_dict(params)
                pred = None
                while device_resident:
                    try:
                        pred = sliding_window_predict_device_resident(
                            data, self._tile_fn, tile_size, num_out,
                            tile_batch_size=tile_batches[0], **kw)
                        break
                    except RuntimeError as e:
                        if not is_oom_error(e):
                            raise
                    # the failed attempt's tensors went with its traceback at the
                    # end of the except clause: hand their memory back to the device
                    torch.cuda.empty_cache()
                    if len(tile_batches) > 1:
                        tile_batches.pop(0)
                    else:
                        device_resident = False
                    if self.verbose:
                        print("device-resident sliding window out of memory; "
                              + (f"retrying with tile_batch_size={tile_batches[0]}"
                                 if device_resident else "streaming the tiles"))
                if pred is None:
                    pred = sliding_window_predict(data, self._tile_fn, tile_size, num_out,
                                                  tile_batch_size=tile_batches[0],
                                                  verbose=self.verbose, **kw)
                logits = pred if logits is None else logits + pred
            with span("predict.download"):
                return logits / len(self.list_of_parameters)

    def predict_single_npy_array(self, input_image: np.ndarray, image_properties: dict,
                                 segmentation_previous_stage: Optional[np.ndarray] = None
                                 ) -> np.ndarray:
        """(c, x, y, z) raw image + properties -> segmentation on the original grid."""
        pp = self.configuration_manager.preprocessor_class(verbose=self.verbose)
        props = dict(image_properties)
        data, _ = pp.run_case_npy(input_image.astype(np.float32), None, props,
                                  self.plans_manager, self.configuration_manager,
                                  self.dataset_json)
        if segmentation_previous_stage is not None:
            data = self._stack_previous_stage(data, segmentation_previous_stage)
        logits = self.predict_sliding_window_return_logits(data)
        return convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, self.plans_manager, self.configuration_manager, self.label_manager, props)

    @staticmethod
    def _make_preprocessing_pool(num_workers: int):
        """Spawned worker processes when num_workers > 1, else one thread."""
        if num_workers > 1:
            ctx = multiprocessing.get_context("spawn")
            return ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx)
        return ThreadPoolExecutor(max_workers=1)

    def _stack_previous_stage(self, data: np.ndarray, prev_seg: np.ndarray) -> np.ndarray:
        onehot = convert_labelmap_to_one_hot(prev_seg, self.label_manager.foreground_labels,
                                             output_dtype=data.dtype)
        return np.vstack([data, onehot])

    def _manage_input_and_output_lists(
            self, list_of_lists_or_source_folder, output_folder_or_list,
            folder_with_segs_from_prev_stage=None, overwrite: bool = True,
            part_id: int = 0, num_parts: int = 1, save_probabilities: bool = False):
        ending = self.dataset_json["file_ending"]
        if isinstance(list_of_lists_or_source_folder, str):
            src = list_of_lists_or_source_folder
            idents = sorted({f[: -len(ending)].rsplit("_", 1)[0]
                             for f in os.listdir(src) if f.endswith(ending)})
            n_channels = len(self.dataset_json.get("channel_names",
                                                   self.dataset_json.get("modality")))
            list_of_lists = [[os.path.join(src, f"{i}_{c:04d}{ending}")
                              for c in range(n_channels)] for i in idents]
        else:
            list_of_lists = list(list_of_lists_or_source_folder)
            idents = [os.path.basename(files[0])[: -len(ending)].rsplit("_", 1)[0]
                      for files in list_of_lists]

        if isinstance(output_folder_or_list, str):
            out_files = [os.path.join(output_folder_or_list, i) for i in idents]
        elif output_folder_or_list is None:
            out_files = [None] * len(idents)
        else:
            out_files = list(output_folder_or_list)

        prev_stage_files = [os.path.join(folder_with_segs_from_prev_stage, i + ending)
                            if folder_with_segs_from_prev_stage else None for i in idents]

        # part sharding
        list_of_lists = list_of_lists[part_id::num_parts]
        out_files = out_files[part_id::num_parts]
        prev_stage_files = prev_stage_files[part_id::num_parts]

        if not overwrite:
            keep = [i for i, of in enumerate(out_files)
                    if of is None or not os.path.isfile(of + ending)
                    or (save_probabilities and not os.path.isfile(of + ".npz"))]
            list_of_lists = [list_of_lists[i] for i in keep]
            out_files = [out_files[i] for i in keep]
            prev_stage_files = [prev_stage_files[i] for i in keep]
        return list_of_lists, out_files, prev_stage_files

    def _write_provenance(self, folder: str, args: dict) -> None:
        """Every predict_from_files argument, dataset.json and plans.json, so
        that postprocessing and ensembling can reconstruct the run."""
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "predict_from_raw_data_args.json"), "w") as f:
            json.dump(args, f, indent=2)
        if self.dataset_json is not None:
            with open(os.path.join(folder, "dataset.json"), "w") as f:
                json.dump(self.dataset_json, f, indent=2, sort_keys=False)
        if self.plans_manager is not None:
            with open(os.path.join(folder, "plans.json"), "w") as f:
                json.dump(self.plans_manager.plans, f, indent=2, sort_keys=False)

    def predict_from_files(self, list_of_lists_or_source_folder, output_folder_or_list,
                           save_probabilities: bool = False, overwrite: bool = True,
                           num_processes_preprocessing: int = 3,
                           num_processes_segmentation_export: int = 3,
                           folder_with_segs_from_prev_stage: Optional[str] = None,
                           num_parts: int = 1, part_id: int = 0):
        """Segment raw cases: a folder of `{case}_{channel:04d}{ending}` files
        or a list of per-case file lists, into a folder (`{case}{ending}`,
        and `{case}.npz` + properties with save_probabilities) or a list of
        output paths; None returns the logits. Returns the output paths (or
        logits) in case order; overwrite=False skips finished cases."""
        if isinstance(output_folder_or_list, str):
            self._write_provenance(output_folder_or_list, {
                "list_of_lists_or_source_folder": (
                    list_of_lists_or_source_folder
                    if isinstance(list_of_lists_or_source_folder, str)
                    else [list(files) for files in list_of_lists_or_source_folder]),
                "output_folder_or_list": output_folder_or_list,
                "save_probabilities": save_probabilities,
                "overwrite": overwrite,
                "num_processes_preprocessing": num_processes_preprocessing,
                "num_processes_segmentation_export": num_processes_segmentation_export,
                "folder_with_segs_from_prev_stage": folder_with_segs_from_prev_stage,
                "num_parts": num_parts, "part_id": part_id,
                "tile_step_size": self.tile_step_size,
                "use_gaussian": self.use_gaussian,
                "use_mirroring": self.use_mirroring,
                "tile_batch_size": self.tile_batch_size,
                "configuration_name": self._configuration_name,
            })

        lists, out_files, prev_files = self._manage_input_and_output_lists(
            list_of_lists_or_source_folder, output_folder_or_list,
            folder_with_segs_from_prev_stage, overwrite, part_id, num_parts, save_probabilities)
        if not lists:
            return []

        results, self.case_timings = [], []
        fg = (tuple(self.label_manager.foreground_labels)
              if self.configuration_manager.previous_stage_name is not None else None)
        with ThreadPoolExecutor(max_workers=max(1, num_processes_segmentation_export)) as \
                export_pool, self._make_preprocessing_pool(num_processes_preprocessing) as pp_pool:
            def submit(images, prev):
                return pp_pool.submit(_preprocess_case, self.plans_manager,
                                      self.configuration_manager, self.dataset_json, images,
                                      prev, fg, self.verbose)
            # bounded prefetch window: at most num_processes_preprocessing + 1
            # cases in flight, so preprocessed fp32 volumes cannot pile up
            # ahead of the prediction
            window = max(1, num_processes_preprocessing) + 1
            work = list(zip(lists, prev_files))
            pp_futures = [submit(im, pv) for im, pv in work[:window]]
            next_submit = len(pp_futures)
            exports = []
            for i, out_file in enumerate(out_files):
                t0 = time.perf_counter()
                data_pp, props = pp_futures[i].result()
                t1 = time.perf_counter()
                pp_futures[i] = None  # release the preprocessed volume
                if next_submit < len(work):
                    pp_futures.append(submit(*work[next_submit]))
                    next_submit += 1
                if self.verbose:
                    print(f"predicting case {i + 1}/{len(out_files)}: {data_pp.shape}")
                logits = self.predict_sliding_window_return_logits(data_pp)
                self.case_timings.append({"fetch_wait": t1 - t0,
                                          "sliding_window": time.perf_counter() - t1})
                if out_file is not None:
                    exports.append(export_pool.submit(
                        _timed, export_prediction_from_logits, logits, props,
                        self.configuration_manager, self.plans_manager, self.dataset_json,
                        out_file, save_probabilities))
                    results.append(out_file)
                else:
                    results.append(logits)
            for timing, fu in zip(self.case_timings, exports):
                timing["export"] = fu.result()
        return results

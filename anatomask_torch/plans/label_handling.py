"""Label semantics: plain labels, region-based training, ignore label. The
port's own copy of anatomask_tpu/plans/label_handling.py (LabelManager,
convert_labelmap_to_one_hot, determine_num_input_channels), numpy on the host.

- region detection (any label value that is a list/tuple of >1 ints)
- ignore label must be max(all_labels)+1
- inference nonlinearity: sigmoid for regions, softmax over channel 0 otherwise
- probabilities -> segmentation (argmax, or thresholded region painting in
  regions_class_order)
- revert-cropping padding with background probability 1
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np


def softmax_np(x: np.ndarray, axis: int = 0) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x, dtype=np.float32)
    return e / e.sum(axis=axis, keepdims=True)


def sigmoid_np(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x.astype(np.float32)))


class LabelManager:
    def __init__(
        self,
        label_dict: dict,
        regions_class_order: Optional[List[int]],
        force_use_labels: bool = False,
        inference_nonlin=None,
    ):
        self._sanity_check(label_dict)
        self.label_dict = label_dict
        self.regions_class_order = regions_class_order
        self._force_use_labels = force_use_labels

        if force_use_labels:
            self._has_regions = False
        else:
            self._has_regions = any(
                isinstance(v, (tuple, list)) and len(v) > 1 for v in label_dict.values()
            )

        self._ignore_label = self._determine_ignore_label()
        self._all_labels = self._get_all_labels()
        self._regions = self._get_regions()

        if self.has_ignore_label:
            assert self.ignore_label == max(self.all_labels) + 1, (
                "If an ignore label is used it must have the highest label value "
                "(max(all_labels)+1); it cannot be 0 or between other labels."
            )

        if inference_nonlin is None:
            self.inference_nonlin = sigmoid_np if self._has_regions else softmax_np
        else:
            self.inference_nonlin = inference_nonlin

    @staticmethod
    def _sanity_check(label_dict: dict):
        if "background" not in label_dict:
            raise RuntimeError("Background label not declared (it should be label 0)")
        bg = label_dict["background"]
        if isinstance(bg, (tuple, list)):
            raise RuntimeError(f"Background label must be 0, not a list/tuple: {bg}")
        assert int(bg) == 0, f"Background label must be 0, got: {bg}"

    def _get_all_labels(self) -> List[int]:
        all_labels = []
        for k, r in self.label_dict.items():
            if k == "ignore":
                continue
            if isinstance(r, (tuple, list)):
                all_labels.extend(int(ri) for ri in r)
            else:
                all_labels.append(int(r))
        return sorted(set(all_labels))

    def _get_regions(self) -> Optional[List[Union[int, Tuple[int, ...]]]]:
        if not self._has_regions or self._force_use_labels:
            return None
        assert self.regions_class_order is not None, (
            "region-based training requires regions_class_order in dataset.json"
        )
        regions = []
        for k, r in self.label_dict.items():
            if k == "ignore":
                continue
            if (np.isscalar(r) and r == 0) or (
                isinstance(r, (tuple, list)) and set(np.unique(r).tolist()) == {0}
            ):
                continue
            regions.append(tuple(r) if isinstance(r, list) else r)
        assert len(self.regions_class_order) == len(regions), (
            "regions_class_order must have as many entries as there are regions"
        )
        return regions

    def _determine_ignore_label(self) -> Optional[int]:
        ig = self.label_dict.get("ignore")
        if ig is not None:
            assert isinstance(ig, int), (
                f"Ignore label must be an integer, not a region. Got {type(ig)}."
            )
        return ig

    # --- properties -----------------------------------------------------------
    @property
    def has_regions(self) -> bool:
        return self._has_regions

    @property
    def has_ignore_label(self) -> bool:
        return self._ignore_label is not None

    @property
    def all_regions(self):
        return self._regions

    @property
    def all_labels(self) -> List[int]:
        return self._all_labels

    @property
    def ignore_label(self) -> Optional[int]:
        return self._ignore_label

    @staticmethod
    def filter_background(classes_or_regions):
        def is_bg(i):
            if isinstance(i, (tuple, list)):
                u = set(np.unique(i).tolist())
                return u == {0}
            return i == 0
        return [i for i in classes_or_regions if not is_bg(i)]

    @property
    def foreground_regions(self):
        return self.filter_background(self.all_regions)

    @property
    def foreground_labels(self) -> List[int]:
        return self.filter_background(self.all_labels)

    @property
    def num_segmentation_heads(self) -> int:
        return len(self.foreground_regions) if self.has_regions else len(self.all_labels)

    # --- logits -> segmentation ----------------------------------------------
    def apply_inference_nonlin(self, logits: np.ndarray) -> np.ndarray:
        """logits: (c, x, y, z) -> probabilities of same shape."""
        return self.inference_nonlin(np.asarray(logits, dtype=np.float32))

    def convert_probabilities_to_segmentation(self, probs: np.ndarray) -> np.ndarray:
        assert probs.shape[0] == self.num_segmentation_heads, (
            f"expected {self.num_segmentation_heads} channels, got {probs.shape[0]}"
        )
        if self.has_regions:
            seg = np.zeros(probs.shape[1:], dtype=np.uint16)
            for i, c in enumerate(self.regions_class_order):
                seg[probs[i] > 0.5] = c
            return seg
        return probs.argmax(0)

    def convert_logits_to_segmentation(self, logits: np.ndarray) -> np.ndarray:
        return self.convert_probabilities_to_segmentation(self.apply_inference_nonlin(logits))

    def revert_cropping_on_probabilities(
        self, probs: np.ndarray, bbox: List[List[int]], original_shape
    ) -> np.ndarray:
        """Paste (c, *cropped_shape) probabilities back into the full pre-crop grid.

        Padded voxels get background probability 1 (labels mode) or all-zeros
        (regions mode) so downstream segmentation conversion is correct.
        """
        out = np.zeros((probs.shape[0], *original_shape), dtype=probs.dtype)
        if not self.has_regions:
            out[0] = 1
        slicer = tuple(slice(int(b[0]), int(b[1])) for b in bbox)
        out[(slice(None), *slicer)] = probs
        return out


def convert_labelmap_to_one_hot(segmentation: np.ndarray, all_labels, output_dtype=np.uint8) -> np.ndarray:
    """(x,y,z) int labels -> (len(all_labels), x,y,z) one-hot. Labels must be consecutive."""
    result = np.zeros((len(all_labels), *segmentation.shape), dtype=output_dtype)
    for i, l in enumerate(all_labels):
        result[i] = segmentation == l
    return result


def determine_num_input_channels(plans_manager, configuration_or_config_manager, dataset_json: dict) -> int:
    if isinstance(configuration_or_config_manager, str):
        cm = plans_manager.get_configuration(configuration_or_config_manager)
    else:
        cm = configuration_or_config_manager
    lm = plans_manager.get_label_manager(dataset_json)
    num_modalities = len(dataset_json.get("modality", dataset_json.get("channel_names")))
    if cm.previous_stage_name is not None:
        # cascade stages stack a one-hot of the previous-stage prediction
        return num_modalities + len(lm.foreground_labels)
    return num_modalities

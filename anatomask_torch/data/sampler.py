"""Patch sampling with foreground oversampling. The port's own copy of
anatomask_tpu/data/sampler.py: numpy's RandomState draws, so one seed gives
the same boxes as the JAX package's sampler, with the forced-foreground tail
of the batch or, with `probabilistic_oversampling`, a draw per sample; with
`cascade_corruption`, a cascade stage's previous-stage segmentation (seg
channel 1) corrupted per patch, its draws interleaved with the boxes' as in
JAX. Per-case sampling probabilities and extra side padding are not copied:
no path of the port uses them.

Output is channels-LAST (B, x, y, z, c) float32 data + (B, x, y, z) int16 seg,
ready for the on-device augmentation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from anatomask_torch.data.dataset import CaseDataset


class PatchSampler:
    def __init__(
        self,
        dataset: CaseDataset,
        batch_size: int,
        patch_size: Sequence[int],          # sampled (possibly enlarged) patch
        final_patch_size: Optional[Sequence[int]] = None,  # network patch
        oversample_foreground_percent: float = 0.33,
        annotated_classes_key: Optional[tuple] = None,
        has_ignore: bool = False,
        seed: Optional[int] = None,
        load_seg: bool = True,
        probabilistic_oversampling: bool = False,
        cascade_corruption: bool = False,
        cascade_p_binary_op: float = 0.4,
        cascade_p_remove_component: float = 0.2,
    ):
        self.dataset = dataset
        self.indices = list(dataset.keys())
        self.batch_size = batch_size
        self.patch_size = np.asarray(patch_size, dtype=int)
        final = np.asarray(final_patch_size if final_patch_size is not None else patch_size, dtype=int)
        self.need_to_pad = (self.patch_size - final).astype(int)
        self.oversample_foreground_percent = oversample_foreground_percent
        self.probabilistic_oversampling = probabilistic_oversampling
        self.annotated_classes_key = annotated_classes_key
        self.has_ignore = has_ignore
        self.cascade_corruption = cascade_corruption
        self.cascade_p_binary_op = cascade_p_binary_op
        self.cascade_p_remove_component = cascade_p_remove_component
        # SSL pretraining: labels feed only the fg-oversampling bbox logic
        # (class_locations in the properties); skip the seg voxel crop/pad
        self.load_seg = load_seg
        self.rng = np.random.RandomState(seed)

    def _do_oversample(self, sample_idx: int) -> bool:
        if self.probabilistic_oversampling:
            return bool(self.rng.uniform() < self.oversample_foreground_percent)
        # last X% of the batch is forced-foreground (reference
        # _oversample_last_XX_percent). With mesh data parallelism the "batch"
        # here is the per-shard batch; use oversample_percent already adjusted
        # per shard (see trainer._set_batch_size_and_oversample).
        return not sample_idx < round(self.batch_size * (1 - self.oversample_foreground_percent))

    def get_bbox(self, data_shape: np.ndarray, force_fg: bool,
                 class_locations: Optional[dict]) -> Tuple[List[int], List[int]]:
        need_to_pad = self.need_to_pad.copy()
        dim = len(data_shape)
        for d in range(dim):
            if need_to_pad[d] + data_shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - data_shape[d]
        lbs = [-need_to_pad[i] // 2 for i in range(dim)]
        ubs = [data_shape[i] + need_to_pad[i] // 2 + need_to_pad[i] % 2 - self.patch_size[i]
               for i in range(dim)]

        selected_voxel = None
        if force_fg or self.has_ignore:
            if not force_fg and self.has_ignore:
                selected_class = self.annotated_classes_key
                if class_locations is None or len(class_locations.get(selected_class, [])) == 0:
                    selected_class = None
            elif force_fg:
                assert class_locations is not None, "force_fg requires class_locations"
                eligible = [k for k, v in class_locations.items() if len(v) > 0]
                # drop the all-annotated pseudo-class if real classes exist
                if self.annotated_classes_key in eligible and len(eligible) > 1:
                    eligible.remove(self.annotated_classes_key)
                if len(eligible) == 0:
                    selected_class = None
                else:
                    selected_class = eligible[self.rng.choice(len(eligible))]
            else:
                selected_class = None
            if selected_class is not None:
                locs = class_locations[selected_class]
                selected_voxel = locs[self.rng.choice(len(locs))]

        if selected_voxel is not None:
            # center the patch on the sampled voxel (coords are (0, x, y, z))
            bbox_lbs = [max(lbs[i], int(selected_voxel[i + 1]) - self.patch_size[i] // 2)
                        for i in range(dim)]
        else:
            bbox_lbs = [self.rng.randint(lbs[i], ubs[i] + 1) for i in range(dim)]
        bbox_ubs = [bbox_lbs[i] + int(self.patch_size[i]) for i in range(dim)]
        return bbox_lbs, bbox_ubs

    def _corrupt_previous_stage(self, prev_seg: np.ndarray) -> np.ndarray:
        """nnU-Net's cascade transforms on one patch of the previous stage's
        segmentation, per label in np.unique's order: with
        cascade_p_binary_op a random dilation, erosion, opening or closing
        (1-3 iterations; ApplyRandomBinaryOperatorTransform), then with
        cascade_p_remove_component the removal of one random connected
        component under 15% of the label's voxels
        (RemoveRandomConnectedComponentFromOneHotEncodingTransform). Host
        scipy; the draws (uniform, choice(4), randint(1, 4), uniform, the
        component) are JAX's, in its order."""
        from scipy.ndimage import (binary_closing, binary_dilation, binary_erosion,
                                   binary_opening, label)
        out = prev_seg.copy()
        labels = [v for v in np.unique(out) if v > 0]
        for v in labels:
            mask = out == v
            if self.rng.uniform() < self.cascade_p_binary_op:
                op = self.rng.choice(4)
                it = self.rng.randint(1, 4)
                fn = [binary_dilation, binary_erosion, binary_opening, binary_closing][op]
                new_mask = fn(mask, iterations=it)
                out[mask & ~new_mask] = 0
                out[new_mask & (out == 0)] = v
                mask = new_mask
            if self.rng.uniform() < self.cascade_p_remove_component:
                lab, n = label(mask)
                if n > 1:
                    sizes = np.bincount(lab.ravel())[1:]
                    fg = sizes.sum()
                    small = [i + 1 for i, sz in enumerate(sizes) if sz < 0.15 * fg]
                    if small:
                        out[lab == small[self.rng.choice(len(small))]] = 0
        return out

    def generate_batch(self) -> Dict[str, np.ndarray]:
        keys = [self.indices[i] for i in self.rng.choice(
            len(self.indices), self.batch_size, replace=True)]
        data_batch = None
        seg_batch = None
        for j, key in enumerate(keys):
            force_fg = self._do_oversample(j)
            data, seg, properties = self.dataset.load_case(key)
            shape = np.asarray(data.shape[1:])
            bbox_lbs, bbox_ubs = self.get_bbox(shape, force_fg, properties.get("class_locations"))

            valid_lbs = [max(0, l) for l in bbox_lbs]
            valid_ubs = [min(int(s), u) for s, u in zip(shape, bbox_ubs)]
            slicer = tuple(slice(l, u) for l, u in zip(valid_lbs, valid_ubs))
            data_crop = np.asarray(data[(slice(None), *slicer)])

            pads = [(0, 0)] + [
                (-min(0, l), max(u - int(s), 0))
                for l, u, s in zip(bbox_lbs, bbox_ubs, shape)
            ]
            data_crop = np.pad(data_crop, pads, mode="constant", constant_values=0)

            seg_crop = None
            if self.load_seg:
                seg_crop = np.asarray(seg[(slice(None), *slicer)])
                seg_crop = np.pad(seg_crop, pads, mode="constant", constant_values=-1)
                if self.cascade_corruption and seg_crop.shape[0] > 1:
                    seg_crop[1] = self._corrupt_previous_stage(seg_crop[1])

            if data_batch is None:
                data_batch = np.empty((self.batch_size, *data_crop.shape), dtype=np.float32)
                if self.load_seg:
                    seg_batch = np.empty((self.batch_size, *seg_crop.shape), dtype=np.int16)
            data_batch[j] = data_crop
            if self.load_seg:
                seg_batch[j] = seg_crop

        # channels-last for the device pipeline
        out = {"data": np.moveaxis(data_batch, 1, -1), "keys": keys}
        if self.load_seg:
            out["seg"] = np.moveaxis(seg_batch, 1, -1)
        return out

"""Dataset fingerprint extraction. The port's own copy of
anatomask_tpu/planning/fingerprint.py (nnU-Net's fingerprint_extractor.py).

Per case: read, crop to the nonzero region, sample foreground intensities
(10e7 voxels over the dataset, with replacement, RandomState(1234) a case);
then per channel the mean, median, std, min, max and the 0.5 and 99.5
percentiles, with the shapes after cropping, the spacings and the median
relative size after cropping, into dataset_fingerprint.json. Host numpy;
cases are read in spawned worker processes when num_processes > 1.
"""
from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Union

import numpy as np

from anatomask_torch.imageio.registry import determine_reader_writer_from_dataset_json
from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import load_json, save_json
from anatomask_torch.preprocessing.cropping import crop_to_nonzero
from anatomask_torch.utils.helpers import (get_case_identifiers_from_raw, get_filenames_of_case,
                                           maybe_convert_to_dataset_name)


def collect_foreground_intensities(segmentation: np.ndarray, images: np.ndarray,
                                   seed: int = 1234, num_samples: int = 10000):
    assert images.ndim == 4 and segmentation.ndim == 4
    assert not np.any(np.isnan(segmentation)), "Segmentation contains NaN values"
    assert not np.any(np.isnan(images)), "Images contain NaN values"
    rs = np.random.RandomState(seed)
    per_channel = []
    stats_per_channel = []
    fg_mask = segmentation[0] > 0
    for i in range(len(images)):
        fg = images[i][fg_mask]
        n = len(fg)
        # sampled with replacement, so that small foregrounds count fully
        per_channel.append(rs.choice(fg, num_samples, replace=True) if n > 0 else [])
        stats_per_channel.append({
            "mean": float(np.mean(fg)) if n else np.nan,
            "median": float(np.median(fg)) if n else np.nan,
            "min": float(np.min(fg)) if n else np.nan,
            "max": float(np.max(fg)) if n else np.nan,
            "percentile_99_5": float(np.percentile(fg, 99.5)) if n else np.nan,
            "percentile_00_5": float(np.percentile(fg, 0.5)) if n else np.nan,
        })
    return per_channel, stats_per_channel


def analyze_case(image_files: List[str], seg_file: str, reader_writer_class,
                 num_samples: int = 10000):
    rw = reader_writer_class()
    images, props = rw.read_images(image_files)
    seg, _ = rw.read_seg(seg_file)
    data_cropped, seg_cropped, _ = crop_to_nonzero(images, seg)
    fg_intensities, fg_stats = collect_foreground_intensities(seg_cropped, data_cropped,
                                                              num_samples=num_samples)
    relative_size = np.prod(data_cropped.shape[1:]) / np.prod(images.shape[1:])
    return data_cropped.shape[1:], props["spacing"], fg_intensities, fg_stats, relative_size


class DatasetFingerprintExtractor:
    def __init__(self, dataset_name_or_id: Union[str, int], num_processes: int = 8,
                 verbose: bool = False):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.verbose = verbose
        self.input_folder = os.path.join(require("raw"), self.dataset_name)
        self.num_processes = num_processes
        self.dataset_json = load_json(os.path.join(self.input_folder, "dataset.json"))
        self.num_foreground_voxels_for_intensitystats = 10e7

    def run(self, overwrite_existing: bool = False) -> dict:
        out_dir = os.path.join(require("preprocessed"), self.dataset_name)
        os.makedirs(out_dir, exist_ok=True)
        properties_file = os.path.join(out_dir, "dataset_fingerprint.json")
        if os.path.isfile(properties_file) and not overwrite_existing:
            return load_json(properties_file)

        identifiers = get_case_identifiers_from_raw(self.input_folder, self.dataset_json)
        cases = [get_filenames_of_case(self.input_folder, i, self.dataset_json)
                 for i in identifiers]
        rw_class = determine_reader_writer_from_dataset_json(self.dataset_json, cases[0][0][0])
        num_samples_per_case = int(self.num_foreground_voxels_for_intensitystats // len(cases))

        if self.num_processes <= 1:
            results = [analyze_case(imgs, seg, rw_class, num_samples_per_case)
                       for imgs, seg in cases]
        else:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=self.num_processes, mp_context=ctx) as ex:
                results = list(ex.map(
                    analyze_case,
                    [c[0] for c in cases], [c[1] for c in cases],
                    [rw_class] * len(cases), [num_samples_per_case] * len(cases),
                ))

        shapes_after_crop = [r[0] for r in results]
        spacings = [r[1] for r in results]
        fg_per_channel = [
            np.concatenate([np.asarray(r[2][i]) for r in results if len(r[2][i]) > 0])
            for i in range(len(results[0][2]))
        ]
        median_relative_size = float(np.median([r[4] for r in results], 0))

        intensity_stats = {}
        for i, fg in enumerate(fg_per_channel):
            intensity_stats[str(i)] = {
                "mean": float(np.mean(fg)),
                "median": float(np.median(fg)),
                "std": float(np.std(fg)),
                "min": float(np.min(fg)),
                "max": float(np.max(fg)),
                "percentile_99_5": float(np.percentile(fg, 99.5)),
                "percentile_00_5": float(np.percentile(fg, 0.5)),
            }

        fingerprint = {
            "spacings": [list(map(float, s)) for s in spacings],
            "shapes_after_crop": [list(map(int, s)) for s in shapes_after_crop],
            "foreground_intensity_properties_per_channel": intensity_stats,
            "median_relative_size_after_cropping": median_relative_size,
        }
        try:
            save_json(fingerprint, properties_file, sort_keys=False)
        except Exception:
            if os.path.isfile(properties_file):
                os.remove(properties_file)
            raise
        return fingerprint

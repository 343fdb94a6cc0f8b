"""Dataset naming and case discovery. The port's own copy of the part of
anatomask_tpu/utils/helpers.py that the PretrainTrainer, the preprocessor
and the predictor read."""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple, Union

from anatomask_torch import paths


def maybe_convert_to_dataset_name(dataset_name_or_id: Union[int, str]) -> str:
    """Accepts 9, '9', 'Dataset009_Spleen' -> full dataset dir name.

    Integer ids are resolved by scanning the raw/preprocessed/results trees for a
    matching DatasetXXX_* directory.
    """
    if isinstance(dataset_name_or_id, str) and dataset_name_or_id.startswith("Dataset"):
        return dataset_name_or_id
    try:
        dataset_id = int(dataset_name_or_id)
    except ValueError:
        raise ValueError(
            f"dataset_name_or_id must be an integer or start with 'Dataset', got {dataset_name_or_id!r}"
        )
    candidates = set()
    for base in (paths.get(w) for w in ("raw", "preprocessed", "results")):
        if base is not None and os.path.isdir(base):
            for d in os.listdir(base):
                m = re.match(r"Dataset(\d{3})_", d)
                if m and int(m.group(1)) == dataset_id:
                    candidates.add(d)
    if len(candidates) == 0:
        raise RuntimeError(f"Could not find a dataset with id {dataset_id}")
    if len(candidates) > 1:
        raise RuntimeError(f"Multiple datasets with id {dataset_id}: {sorted(candidates)}")
    return candidates.pop()


def get_case_identifiers_from_raw(raw_dataset_dir: str, dataset_json: dict) -> List[str]:
    """Case identifiers from imagesTr file names (strip _XXXX channel + ending)."""
    ending = dataset_json["file_ending"]
    images_dir = os.path.join(raw_dataset_dir, "imagesTr")
    idents = set()
    for f in sorted(os.listdir(images_dir)):
        if f.endswith(ending):
            stem = f[: -len(ending)]
            idents.add(stem.rsplit("_", 1)[0])
    return sorted(idents)


def get_filenames_of_case(raw_dataset_dir: str, identifier: str, dataset_json: dict,
                          images_dir: str = "imagesTr", labels_dir: str = "labelsTr"
                          ) -> Tuple[List[str], Optional[str]]:
    ending = dataset_json["file_ending"]
    n_channels = len(dataset_json.get("channel_names", dataset_json.get("modality", {"0": "?"})))
    images = [
        os.path.join(raw_dataset_dir, images_dir, f"{identifier}_{c:04d}{ending}")
        for c in range(n_channels)
    ]
    seg = os.path.join(raw_dataset_dir, labels_dir, f"{identifier}{ending}")
    if not os.path.isfile(seg):
        seg = None
    return images, seg


def get_identifiers_from_split_files(folder: str) -> List[str]:
    """Case identifiers from a preprocessed data folder (.npz files)."""
    return sorted({f[:-4] for f in os.listdir(folder) if f.endswith(".npz")})

"""Dataset naming. The port's own copy of the part of
anatomask_tpu/utils/helpers.py that the PretrainTrainer reads."""
from __future__ import annotations

import os
import re
from typing import Union

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

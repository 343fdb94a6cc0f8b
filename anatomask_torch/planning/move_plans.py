"""Plans transfer between datasets. The port's own copy of
anatomask_tpu/planning/move_plans.py (nnU-Net's
move_plans_between_datasets.py): the source dataset's plans are written
into the target dataset's preprocessed folder with the dataset name and the
data identifiers rewritten, so that the target is preprocessed with the
source's patch, spacing and topology (pretraining on one dataset,
finetuning on another).
"""
from __future__ import annotations

import os

from anatomask_torch.paths import require
from anatomask_torch.plans.plans_handler import load_json, save_json
from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name


def move_plans_between_datasets(
    source_dataset_name_or_id,
    target_dataset_name_or_id,
    source_plans_identifier: str = "ATKPlans",
    target_plans_identifier: str = None,
) -> str:
    """Copies the source dataset's plans into the target's preprocessed
    folder, identifiers rewritten. Returns the written plans path."""
    source = maybe_convert_to_dataset_name(source_dataset_name_or_id)
    target = maybe_convert_to_dataset_name(target_dataset_name_or_id)
    target_plans_identifier = target_plans_identifier or source_plans_identifier
    pp = require("preprocessed")
    plans = load_json(os.path.join(pp, source, source_plans_identifier + ".json"))

    plans["dataset_name"] = target
    plans["plans_name"] = target_plans_identifier
    for cfg_name, cfg in plans["configurations"].items():
        if "data_identifier" in cfg:
            ident = cfg["data_identifier"]
            if ident.startswith(source_plans_identifier):
                cfg["data_identifier"] = target_plans_identifier + ident[len(source_plans_identifier):]
            else:
                cfg["data_identifier"] = f"{target_plans_identifier}_{cfg_name}"

    os.makedirs(os.path.join(pp, target), exist_ok=True)
    out = os.path.join(pp, target, target_plans_identifier + ".json")
    save_json(plans, out, sort_keys=False)
    return out

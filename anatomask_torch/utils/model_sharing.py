"""Model export and install as zip archives. The port's own copy of
anatomask_tpu/utils/model_sharing.py (nnU-Net's model_sharing): a zip of
trained-model folders (plans, dataset.json, the postprocessing decisions, a
checkpoint and debug.json a fold) relative to the results folder, installed
by extracting it there. The layout is the JAX package's, so that a model
exported by either package installs in the other.
"""
from __future__ import annotations

import os
import zipfile
from typing import Sequence, Union

from anatomask_torch.paths import require
from anatomask_torch.utils.helpers import maybe_convert_to_dataset_name


_KEEP_FILES = ("plans.json", "dataset.json", "postprocessing.json",
               "inference_information.json")
_CKPT_NAMES = ("checkpoint_final.npz", "checkpoint_best.npz")


def export_pretrained_model(
    dataset_name_or_id,
    output_file: str,
    trainer: str = "ATKTrainer",
    plans_identifier: str = "ATKPlans",
    configurations: Sequence[str] = ("3d_fullres",),
    folds: Sequence[Union[int, str]] = (0, 1, 2, 3, 4),
    strict: bool = True,
):
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    results = require("results")
    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED) as zf:
        for config in configurations:
            model_dir = os.path.join(results, dataset_name,
                                     f"{trainer}__{plans_identifier}__{config}")
            if not os.path.isdir(model_dir):
                if strict:
                    raise RuntimeError(f"missing trained model folder {model_dir}")
                continue
            for f in _KEEP_FILES:
                p = os.path.join(model_dir, f)
                if os.path.isfile(p):
                    zf.write(p, os.path.relpath(p, results))
            for fold in folds:
                fdir = os.path.join(model_dir, f"fold_{fold}")
                if not os.path.isdir(fdir):
                    if strict:
                        raise RuntimeError(f"missing fold folder {fdir}")
                    continue
                wrote_ckpt = False
                for ck in _CKPT_NAMES:
                    p = os.path.join(fdir, ck)
                    if os.path.isfile(p):
                        zf.write(p, os.path.relpath(p, results))
                        wrote_ckpt = True
                        break
                if strict and not wrote_ckpt:
                    raise RuntimeError(f"no checkpoint in {fdir}")
                dbg = os.path.join(fdir, "debug.json")
                if os.path.isfile(dbg):
                    zf.write(dbg, os.path.relpath(dbg, results))
    return output_file


def install_model_from_zip_file(zip_file: str):
    results = require("results")
    os.makedirs(results, exist_ok=True)
    with zipfile.ZipFile(zip_file) as zf:
        zf.extractall(results)
    return results

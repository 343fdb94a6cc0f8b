"""Training helpers shared by the trainers. Counterpart of the part of
anatomask_tpu/training/trainer.py that the PretrainTrainer reads; the
supervised Trainer is not ported yet (ROADMAP.md). The port runs on one GPU,
so JAX's `pick_mesh_for_batch` reduces to its single-device case: the global
batch is the configured batch."""
from __future__ import annotations

from typing import List

import numpy as np


def generate_crossval_split(keys: List[str], n_splits: int = 5, seed: int = 12345) -> List[dict]:
    """KFold(5, shuffle, seed 12345) as in nnU-Net's do_split."""
    keys = sorted(keys)
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(keys))
    folds = np.array_split(idx, n_splits)
    splits = []
    for f in range(n_splits):
        val_idx = set(folds[f].tolist())
        splits.append({
            "train": [keys[i] for i in range(len(keys)) if i not in val_idx],
            "val": [keys[i] for i in sorted(val_idx)],
        })
    return splits

"""Checkpoints. Counterpart of anatomask_tpu/training/checkpoint.py.

- `load_checkpoint` reads the JAX package's files and `save_checkpoint`
  writes them: one .npz holding the flattened pytree ('a/b/c' keys, '#i'
  for list items, `flatten_tree`) plus a JSON metadata entry; numpy only,
  no pickle. A trained-model folder for the Predictor is written with them.
- `save_trainer_checkpoint` / `load_trainer_checkpoint` are the port's own
  format for the PretrainTrainer's state (student, teacher, optimizer,
  metadata with the epoch, the SparK and Pretrain configs), written with
  `torch.save` and read back with `weights_only=True`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

SEP = "/"


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}#{i}{SEP}"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix_lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix_lists(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix_lists(v) for k, v in node.items()}

    return fix_lists(root)


def save_checkpoint(path: str, arrays: dict, metadata: Optional[dict] = None,
                    compress: bool = False):
    """arrays: nested dicts/lists of arrays (e.g. {'network_weights':
    params}); metadata: a JSON-serialisable dict. Written to a temporary file
    and renamed; uncompressed unless compress=True. Loading accepts both."""
    flat = flatten_tree(arrays)
    meta = json.dumps(metadata or {})
    tmp = path + ".tmp"
    saver = np.savez_compressed if compress else np.savez
    with open(tmp, "wb") as f:
        saver(f, __metadata__=np.frombuffer(meta.encode(), dtype=np.uint8), **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """Returns (arrays pytree, metadata dict)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__metadata__"}
        meta = json.loads(bytes(z["__metadata__"]).decode()) if "__metadata__" in z.files else {}
    return unflatten_tree(flat), meta


def save_trainer_checkpoint(path: str, state: dict, metadata: dict) -> None:
    """state: {'network_weights': state_dict, 'ema_weights': state_dict,
    'optimizer_state': optimizer state_dict}, every tensor already on the
    host; metadata: a JSON-serialisable dict. Written to a temporary file and
    renamed, so a reader never sees half a checkpoint."""
    tmp = path + ".tmp"
    torch.save({"state": state, "metadata": json.dumps(metadata)}, tmp)
    os.replace(tmp, path)


def load_trainer_checkpoint(path: str, map_location="cpu") -> Tuple[dict, dict]:
    """Returns (state, metadata dict) of a file written by save_trainer_checkpoint."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    return blob["state"], json.loads(blob["metadata"])

"""Reading the JAX package's checkpoints. Counterpart of
anatomask_tpu/training/checkpoint.py (`unflatten_tree`, `load_checkpoint`).

Format: one .npz holding the flattened pytree ('a/b/c' keys, '#i' for list
items) plus a JSON metadata entry; numpy only, no pickle.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np

SEP = "/"


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


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """Returns (arrays pytree, metadata dict)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files if k != "__metadata__"}
        meta = json.loads(bytes(z["__metadata__"]).decode()) if "__metadata__" in z.files else {}
    return unflatten_tree(flat), meta

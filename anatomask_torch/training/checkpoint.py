"""Checkpoints. Counterpart of anatomask_tpu/training/checkpoint.py.

- `load_checkpoint` reads the JAX package's files and `save_checkpoint`
  writes them: one .npz holding the flattened pytree ('a/b/c' keys, '#i'
  for list items, `flatten_tree`) plus a JSON metadata entry; numpy only,
  no pickle. A trained-model folder for the Predictor is written with them.
- `save_trainer_checkpoint` / `load_trainer_checkpoint` are the port's own
  format for the PretrainTrainer's state (student, teacher, optimizer,
  metadata with the epoch, the SparK and Pretrain configs), written with
  `torch.save` and read back with `weights_only=True`; `link_checkpoint`
  gives one such file a second name.
- `load_pretrained_weights` and `transfer_ssl_encoder_weights` are the JAX
  functions' counterparts on the port's state_dicts: a name- and
  shape-matched merge without the segmentation heads, and AnatoMask's
  encoder transfer into a STUNet.
"""
from __future__ import annotations

import json
import os
import shutil
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


def link_checkpoint(src: str, dst: str) -> None:
    """dst as a hard link to the checkpoint src (one file under two names, no
    data written), or a copy where the file system has no hard links; made
    under a temporary name and renamed, as a write."""
    tmp = dst + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    try:
        os.link(src, tmp)
    except OSError:
        shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def load_trainer_checkpoint(path: str, map_location="cpu") -> Tuple[dict, dict]:
    """Returns (state, metadata dict) of a file written by save_trainer_checkpoint."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    return blob["state"], json.loads(blob["metadata"])


def _is_seg_head(key: str) -> bool:
    return "seg_outputs" in key or "seg_layers" in key


def load_pretrained_weights(state_dict: dict, pretrained: dict, verbose: bool = False) -> dict:
    """`state_dict` with every tensor of `pretrained` that it shares by name,
    the segmentation heads excepted. A shared name of another shape raises
    ValueError (the JAX function asserts); names on one side only are
    skipped."""
    out = dict(state_dict)
    loaded, skipped = [], []
    for k, v in pretrained.items():
        if _is_seg_head(k):
            skipped.append(k)
            continue
        if k in out:
            if tuple(out[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"Shape mismatch for {k}: model {tuple(out[k].shape)} vs pretrained "
                    f"{tuple(v.shape)}. Pretrained weights must match the architecture.")
            out[k] = torch.as_tensor(v).to(out[k].dtype)
            loaded.append(k)
    if verbose:
        print(f"loaded {len(loaded)} tensors, skipped seg heads: {skipped}")
    return out


def encoder_key(key: str) -> str:
    """A pretraining key in a STUNet's names: whatever precedes 'sp_cnn.' and
    any 'module.' prefix dropped."""
    key = key.split("sp_cnn.")[-1]
    while key.startswith("module."):
        key = key[len("module."):]
    return key


def transfer_ssl_encoder_weights(stunet_state_dict: dict, ssl_state_dict: dict,
                                 verbose: bool = False) -> dict:
    """AnatoMask's finetuning start: every encoder tensor
    (conv_blocks_context.*) of the pretrained sparse encoder that the STUNet
    has at the same shape replaces the STUNet's; the decoder and the heads
    keep their initialisation."""
    out = dict(stunet_state_dict)
    worked, not_worked = [], []
    for k, v in ssl_state_dict.items():
        k = encoder_key(k)
        if "conv_blocks_context" not in k:
            continue
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = torch.as_tensor(v).to(out[k].dtype)
            worked.append(k)
        else:
            not_worked.append(k)
    if verbose:
        print(f"ssl transfer: {len(worked)} loaded, {len(not_worked)} unmatched: "
              f"{not_worked[:10]}")
    return out

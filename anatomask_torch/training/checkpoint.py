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
- The loaders of the reference's PyTorch checkpoints (AnatoMask's and
  STUNet's published .pth files): `load_torch_checkpoint_file`,
  `load_torch_pretrained_weights` (the variants default/ssl/moco/swin/
  unimiss, the archs stunet/plain_unet/resenc) and
  `expand_input_channel_kernels`. The JAX package's
  `convert_torch_*_state_dict` map such a file to flax trees; here they map
  its names to the port's state_dict names, the tensors unchanged (the
  port's modules keep the reference's layouts), and give the same tensors
  as JAX's loaders followed by `convert.state_dict_from_jax`.
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


# --- the reference's PyTorch checkpoints -------------------------------------

def _strip_wrappers(key: str) -> str:
    """Drop DDP 'module.' prefixes and torch.compile '_orig_mod.' prefixes."""
    for pre in ("module.", "_orig_mod."):
        while key.startswith(pre):
            key = key[len(pre):]
    return key


def _weight_or_bias(pname: str) -> str:
    return "weight" if pname == "weight" else "bias"


def convert_torch_stunet_state_dict(state_dict: dict) -> Dict[str, torch.Tensor]:
    """A reference STUNet (or SparK sparse-encoder) state_dict in the port's
    STUNet names: 'module.' prefixes dropped and the SparK nesting cut at
    'sp_cnn.' (split('sp_cnn.')[-1], as the reference's SSL loader does);
    only the encoder and decoder blocks, upsampling convs and heads are kept."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        k = key
        if "sp_cnn." in k:
            k = k.split("sp_cnn.")[-1]
        while k.startswith("module."):
            k = k[len("module."):]
        k = k.lstrip(".")  # the moco rewrite (split('net')[1][3:]) can leave one
        parts = k.split(".")
        if parts[0] in ("conv_blocks_context", "conv_blocks_localization"):
            stage, block, layer, pname = parts[1], parts[2], parts[3], parts[4]
            if layer.startswith(("conv", "norm")):
                out[f"{parts[0]}.{stage}.{block}.{layer}.{_weight_or_bias(pname)}"] = val
        elif parts[0] == "upsample_layers":
            u, layer, pname = parts[1], parts[2], parts[3]
            out[f"upsample_layers.{u}.{layer}.{_weight_or_bias(pname)}"] = val
        elif parts[0] == "seg_outputs":
            u, pname = parts[1], parts[2]
            out[f"seg_outputs.{u}.{_weight_or_bias(pname)}"] = val
    return out


def convert_torch_spark_state_dict(state_dict: dict) -> Dict[str, torch.Tensor]:
    """A full reference SparK pretraining state_dict (sparse_encoder.sp_cnn,
    densify_norms, densify_projs, mask_tokens, dense_decoder) in the port's
    SparK names. BatchNorm running statistics are dropped (the port's
    decoder norms run in training mode); an Identity densify projection has
    no keys."""
    out: Dict[str, torch.Tensor] = {}
    encoder = {}
    for key, val in state_dict.items():
        k = _strip_wrappers(key)
        parts = k.split(".")
        if parts[0] == "sparse_encoder":
            encoder[k] = val
        elif parts[0] == "densify_norms":
            if parts[2] in ("weight", "bias"):
                out[f"densify_norms.{parts[1]}.{parts[2]}"] = val
        elif parts[0] == "densify_projs":
            out[f"densify_projs.{parts[1]}.{_weight_or_bias(parts[2])}"] = val
        elif parts[0] == "mask_tokens":
            out[f"mask_tokens.{parts[1]}"] = torch.as_tensor(val).reshape(1, -1, 1, 1, 1)
        elif parts[0] == "dense_decoder":
            if parts[1] == "proj":
                out[f"dense_decoder.proj.{_weight_or_bias(parts[2])}"] = val
            elif parts[1] == "dec":
                base = f"dense_decoder.dec.{parts[2]}"
                if parts[3] == "up_sample":
                    out[f"{base}.up_sample.{_weight_or_bias(parts[4])}"] = val
                elif parts[3] == "conv":
                    # Sequential: 0 conv, 1 norm, 2 relu6, 3 conv, 4 norm
                    idx, pname = int(parts[4]), parts[5]
                    if pname in ("running_mean", "running_var", "num_batches_tracked"):
                        continue
                    if idx in (0, 3):
                        out[f"{base}.conv.{idx}.weight"] = val  # the convs have no bias
                    elif idx in (1, 4):
                        out[f"{base}.conv.{idx}.{_weight_or_bias(pname)}"] = val
    out.update({f"sparse_encoder.sp_cnn.{k}": v
                for k, v in convert_torch_stunet_state_dict(encoder).items()})
    return out


def convert_torch_plain_unet_state_dict(state_dict: dict) -> Dict[str, torch.Tensor]:
    """A PlainConvUNet state_dict of dynamic_network_architectures
    (encoder.stages.{s}.convs.{i}.conv/.norm, decoder.stages.{d},
    decoder.transpconvs.{d}, decoder.seg_layers.{d}; ConvDropoutNormReLU's
    second spelling .all_modules.{0,2} read as conv and norm) in the port's
    PlainConvUNet names. Keys of another form are skipped."""
    out: Dict[str, torch.Tensor] = {}

    def conv_block(base, layer, pname, val):
        if layer in ("conv", "norm"):
            out[f"{base}.{layer}.{_weight_or_bias(pname)}"] = val

    for key, val in state_dict.items():
        parts = _strip_wrappers(key).split(".")
        try:
            if parts[0] in ("encoder", "decoder") and parts[1] == "stages":
                s, rest = parts[2], parts[3:]
                if rest[0] == "convs":
                    i, layer, pname = rest[1], rest[2], rest[3]
                    if layer == "all_modules":
                        layer, pname = {"0": "conv", "2": "norm"}.get(rest[3]), rest[4]
                    conv_block(f"{parts[0]}.stages.{s}.convs.{i}", layer, pname, val)
            elif parts[0] == "decoder" and parts[1] in ("transpconvs", "seg_layers"):
                out[f"decoder.{parts[1]}.{parts[2]}.{_weight_or_bias(parts[-1])}"] = val
        except IndexError:
            continue
    return out


def convert_torch_resenc_state_dict(state_dict: dict) -> Dict[str, torch.Tensor]:
    """A ResidualEncoderUNet state_dict (encoder.stages.{s}.blocks.{b}.conv1/
    .norm1/.conv2/.norm2 with the ConvDropoutNormReLU spellings, the skip's
    conv as skip, downsample_skip or conv3; the decoder as PlainConvUNet's) in
    the port's ResidualEncoderUNet names (blocks.{b}.conv1..conv3, norm1,
    norm2)."""
    out = convert_torch_plain_unet_state_dict(
        {k: v for k, v in state_dict.items() if not k.startswith("encoder.")})
    for key, val in state_dict.items():
        k = _strip_wrappers(key)
        if not k.startswith("encoder.stages."):
            continue
        parts = k.split(".")
        try:
            s, rest = parts[2], parts[3:]
            if rest[0] != "blocks":
                continue
            b, layer, pname = rest[1], rest[2], rest[-1]
            base = f"encoder.stages.{s}.blocks.{b}"
            target = None
            if layer in ("conv1", "conv2"):
                sub = rest[3] if len(rest) > 4 else "conv"
                if len(rest) == 4 or sub == "conv" or (sub == "all_modules" and rest[4] == "0"):
                    target = f"{layer}.{_weight_or_bias(pname)}"
                elif (sub == "all_modules" and rest[4] == "2") or sub == "norm":
                    target = f"norm{layer[-1]}.{_weight_or_bias(pname)}"
            elif layer in ("norm1", "norm2"):
                target = f"{layer}.{_weight_or_bias(pname)}"
            elif layer in ("skip", "downsample_skip", "conv3"):
                if pname == "weight" and val.ndim == 5:
                    target = "conv3.weight"
                elif pname == "bias":
                    target = "conv3.bias"
            if target is not None:
                out[f"{base}.{target}"] = val
        except IndexError:
            continue
    return out


_LOADER_SKIP = {
    # the reference's load_pretrained_weights skip lists per variant
    "default": (".seg_layers.", "seg_output", "seg_outputs"),
    "swin": ("out.conv.conv.weight", "out.conv.conv.bias"),
    "unimiss": ("cls_conv.weight", "cls_conv.bias"),
    "ssl": (),
    "moco": (),
}


def load_torch_pretrained_weights(state_dict: dict, state_or_path, variant: str = "default",
                                  arch: str = "stunet", verbose: bool = False,
                                  allow_pickle: bool = False) -> dict:
    """The reference's load_pretrained_weights family on the port's
    state_dicts: 'default', a name- and shape-matched merge without the
    segmentation heads; 'ssl', keys with 'encoder' rewritten by
    split('sp_cnn.')[-1]; 'moco', 'conv_blocks_context' keys rewritten by
    split('net')[1][3:]; 'swin' and 'unimiss', the default merge with their
    own skip lists.

    state_dict: the target network's; state_or_path: a reference state_dict
    or a .pt/.pth file; arch picks the key map ('stunet' | 'plain_unet' |
    'resenc'). Returns `state_dict` with the transferred tensors replaced;
    raises RuntimeError when none transfers."""
    if isinstance(state_or_path, (str, os.PathLike)):
        state = load_torch_checkpoint_file(str(state_or_path), allow_pickle=allow_pickle)
    else:
        state = state_or_path

    if variant == "ssl":
        state = {k.split("sp_cnn.")[-1]: v for k, v in state.items() if "encoder" in k}
    elif variant == "moco":
        state = {k.split("net")[1][3:]: v for k, v in state.items()
                 if "conv_blocks_context" in k and "net" in k}

    key_map = {
        "stunet": convert_torch_stunet_state_dict,
        "plain_unet": convert_torch_plain_unet_state_dict,
        "resenc": convert_torch_resenc_state_dict,
    }[arch]
    pre = key_map(state)

    skip = _LOADER_SKIP.get(variant, _LOADER_SKIP["default"])
    out = dict(state_dict)
    loaded = []
    for k, v in pre.items():
        if any(s.strip(".") in k for s in skip):
            continue
        v = torch.as_tensor(v)
        if k in out and tuple(out[k].shape) == tuple(v.shape):
            out[k] = v.to(out[k].dtype)
            loaded.append(k)
    if verbose:
        print(f"[{variant}/{arch}] transferred {len(loaded)}/{len(pre)} tensors")
    if not loaded:
        raise RuntimeError(
            f"no tensors transferred (variant={variant}, arch={arch}); the "
            f"pretrained weights do not seem compatible with this network")
    return out


def load_torch_checkpoint_file(path: str, allow_pickle: bool = False) -> dict:
    """The network weights of a torch .pth/.pt checkpoint, read on the CPU.
    weights_only=True first (no code from an outside file runs); a legacy
    pickled checkpoint needs an explicit allow_pickle=True."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        if not allow_pickle:
            raise RuntimeError(
                f"{path} is not loadable with weights_only=True; pass "
                f"allow_pickle=True to opt into full (unsafe) unpickling: {e}")
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("network_weights", "state_dict", "model"):
            if key in ckpt:
                return ckpt[key]
    return ckpt


def expand_input_channel_kernels(state_dict: dict, target_in_channels: int) -> dict:
    """The stem's kernels (conv_blocks_context.0) repeated along the input
    channels to fit a network with more of them (the reference's
    load_stunet_for_autopet: weight.repeat(1, 2, 1, 1, 1) for CT -> CT+PET),
    wherever the kernel's input channels divide target_in_channels and are
    fewer."""
    out = dict(state_dict)
    for k, v in state_dict.items():
        if "conv_blocks_context.0." in k and k.endswith("weight") and v.ndim == 5:
            cin = v.shape[1]
            if cin < target_in_channels and target_in_channels % cin == 0:
                out[k] = v.repeat(1, target_in_channels // cin, 1, 1, 1)
    return out

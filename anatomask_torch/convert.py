"""JAX parameters -> the port's state_dicts, and back for the segmentation
networks.

The input is a JAX package param tree as nested dicts of numpy arrays; the
output uses the reference torch models' names, so the JAX package's
`training/checkpoint.py` adapters are the inverses:
`convert_torch_spark_state_dict` of `spark_state_dict_from_jax`,
`convert_torch_stunet_state_dict` of `stunet_state_dict_from_jax`,
`convert_torch_plain_unet_state_dict` of `plain_unet_state_dict_from_jax`
and `convert_torch_resenc_state_dict` of `resenc_state_dict_from_jax`.
`state_dict_from_jax` picks one by the network's architecture name.

- conv kernels DHWIO -> OIDHW: transpose(4, 3, 0, 1, 2);
- SparK's k4s2 ConvTranspose kernels (k, k, k, I, O), correlated un-flipped
  by lax.conv_transpose -> torch (I, O, k, k, k): flip the spatial axes,
  then transpose(3, 4, 0, 1, 2), as `convert_torch_spark_state_dict` flips;
- the U-Nets' k = s transposed convs (s1, s2, s3, I, O) -> (I, O, s1, s2,
  s3): transpose(3, 4, 0, 1, 2) with no flip, as
  `convert_torch_plain_unet_state_dict` has none (`models/layers.py`
  `SubpixelConvTranspose` applies the weight mirrored, as the JAX layer);
- mask tokens (C,) -> (1, C, 1, 1, 1); norm scale/bias -> weight/bias.

`state_dict_to_jax` is `state_dict_from_jax`'s inverse for STUNet,
PlainConvUNet and ResidualEncoderUNet, bit for bit: the supervised trainer
writes its checkpoints in the JAX package's layout with it, so that both
packages' predictors read them.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _conv(k) -> np.ndarray:
    return np.asarray(k).transpose(4, 3, 0, 1, 2)


def _convt(k) -> np.ndarray:
    return np.flip(np.asarray(k), (0, 1, 2)).transpose(3, 4, 0, 1, 2)


def _norm(prefix: str, node: Mapping, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.asarray(node["scale"])
    out[f"{prefix}.bias"] = np.asarray(node["bias"])


def _conv_module(prefix: str, node: Mapping, out: Dict[str, np.ndarray]) -> None:
    """A ConvND's {conv: {kernel, bias}} -> {prefix}.weight, {prefix}.bias."""
    out[f"{prefix}.weight"] = _conv(node["conv"]["kernel"])
    out[f"{prefix}.bias"] = np.asarray(node["conv"]["bias"])


def _tensors(out: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}


def _res_stage(prefix: str, stage: Mapping, out: Dict[str, np.ndarray]) -> None:
    """One STUNet stage: block{b}/conv{1,2,3}/conv/{kernel,bias} and
    block{b}/norm{1,2}/{scale,bias} -> {prefix}.{b}.conv1.weight, ..."""
    for block_name, block in stage.items():
        pre = f"{prefix}.{block_name[len('block'):]}"
        for layer, node in block.items():
            if layer.startswith("conv"):
                _conv_module(f"{pre}.{layer}", node, out)
            else:
                _norm(f"{pre}.{layer}", node, out)


def stunet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX STUNet's params (conv_blocks_context_{d}, upsample_layers_{u},
    conv_blocks_localization_{u}, seg_outputs_{u}) -> the port's STUNet
    state_dict."""
    out: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        kind, i = name.rsplit("_", 1)
        if kind in ("conv_blocks_context", "conv_blocks_localization"):
            _res_stage(f"{kind}.{i}", node, out)
        elif kind == "upsample_layers":
            _conv_module(f"upsample_layers.{i}.conv", node["conv"], out)
        elif kind == "seg_outputs":
            _conv_module(f"seg_outputs.{i}", node, out)
        else:
            raise ValueError(f"not a STUNet parameter: {name}")
    return _tensors(out)


def spark_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    for stage_name, stage in params["sparse_encoder"].items():
        d = stage_name.rsplit("_", 1)[1]
        _res_stage(f"sparse_encoder.sp_cnn.conv_blocks_context.{d}", stage, out)
    for name, node in params.items():
        m = re.fullmatch(r"(densify_norm|densify_proj|mask_token)(\d+)", name)
        if m is None:
            continue
        kind, i = m.groups()
        if kind == "densify_norm":
            _norm(f"densify_norms.{i}", node, out)
        elif kind == "densify_proj":
            _conv_module(f"densify_projs.{i}", node, out)
        else:
            out[f"mask_tokens.{i}"] = np.asarray(node).reshape(1, -1, 1, 1, 1)
    dec = params["dense_decoder"]
    for name, node in dec.items():
        if name == "proj":
            out["dense_decoder.proj.weight"] = _conv(node["kernel"])
            out["dense_decoder.proj.bias"] = np.asarray(node["bias"])
            continue
        prefix = f"dense_decoder.dec.{name[len('dec'):]}"
        out[f"{prefix}.up_sample.weight"] = _convt(node["up_sample"]["conv"]["kernel"])
        out[f"{prefix}.up_sample.bias"] = np.asarray(node["up_sample"]["conv"]["bias"])
        for j in (0, 1):
            out[f"{prefix}.conv.{3 * j}.weight"] = _conv(node[f"conv{j}"]["kernel"])
            _norm(f"{prefix}.conv.{3 * j + 1}", node[f"norm{j}"], out)
    return _tensors(out)


def _unet_decoder(name: str, node: Mapping, out: Dict[str, np.ndarray]) -> bool:
    """decoder_stage_{d}, decoder_transp_{d} and seg_output_{d} of the JAX
    U-Nets -> the port's decoder names; False for any other parameter."""
    kind, d = name.rsplit("_", 1)
    if kind == "decoder_stage":
        _conv_stage(f"decoder.stages.{d}", node, out)
    elif kind == "decoder_transp":
        out[f"decoder.transpconvs.{d}.weight"] = np.asarray(node["kernel"]).transpose(3, 4, 0, 1, 2)
        out[f"decoder.transpconvs.{d}.bias"] = np.asarray(node["bias"])
    elif kind == "seg_output":
        _conv_module(f"decoder.seg_layers.{d}", node, out)
    else:
        return False
    return True


def _conv_stage(prefix: str, stage: Mapping, out: Dict[str, np.ndarray]) -> None:
    """conv{i}/{conv, norm} of a JAX _ConvStage -> {prefix}.convs.{i}.conv/.norm."""
    for conv_name, block in stage.items():
        pre = f"{prefix}.convs.{conv_name[len('conv'):]}"
        _conv_module(f"{pre}.conv", block["conv"], out)
        _norm(f"{pre}.norm", block["norm"], out)


def plain_unet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX PlainConvUNet's params (encoder_stage_{s}, decoder_stage_{d},
    decoder_transp_{d}, seg_output_{d}) -> the port's PlainConvUNet
    state_dict."""
    out: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name.startswith("encoder_stage_"):
            _conv_stage(f"encoder.stages.{name.rsplit('_', 1)[1]}", node, out)
        elif not _unet_decoder(name, node, out):
            raise ValueError(f"not a PlainConvUNet parameter: {name}")
    return _tensors(out)


def resenc_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX ResidualEncoderUNet's params (encoder_stage_{s}_block_{b} with
    conv1, norm1, conv2, norm2 and the skip's conv3; the decoder as
    PlainConvUNet's) -> the port's ResidualEncoderUNet state_dict."""
    out: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        m = re.fullmatch(r"encoder_stage_(\d+)_block_(\d+)", name)
        if m:
            _res_stage(f"encoder.stages.{m[1]}.blocks", {f"block{m[2]}": node}, out)
        elif not _unet_decoder(name, node, out):
            raise ValueError(f"not a ResidualEncoderUNet parameter: {name}")
    return _tensors(out)


def state_dict_from_jax(arch_name: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX params of a network built by `build_network_from_plans` for
    `arch_name` ('STUNet-*', 'PlainConvUNet', 'ResidualEncoderUNet') -> the
    port's state_dict."""
    if arch_name.lower().startswith("stunet"):
        return stunet_state_dict_from_jax(params)
    if arch_name == "PlainConvUNet":
        return plain_unet_state_dict_from_jax(params)
    if arch_name == "ResidualEncoderUNet":
        return resenc_state_dict_from_jax(params)
    raise RuntimeError(f"Unknown network architecture {arch_name!r}")


# --- the port's state_dicts -> JAX parameters ------------------------------------

def _leaf(layer: str, param: str, value: np.ndarray):
    """(path tail, array) of one conv or norm tensor: a conv's OIDHW weight ->
    conv/kernel DHWIO, its bias -> conv/bias; a norm's weight/bias ->
    scale/bias."""
    if layer.startswith("norm"):
        return [layer, "scale" if param == "weight" else "bias"], value
    if param == "weight":
        return [layer, "conv", "kernel"], value.transpose(2, 3, 4, 1, 0)
    return [layer, "conv", "bias"], value


def _jax_path(arch: str, key: str, value: np.ndarray):
    """The JAX tree path and array of one state_dict entry (the inverse of the
    *_state_dict_from_jax functions above)."""
    parts = key.split(".")
    param = parts[-1]
    if arch == "STUNet":
        if parts[0] in ("conv_blocks_context", "conv_blocks_localization"):
            tail, v = _leaf(parts[3], param, value)
            return [f"{parts[0]}_{parts[1]}", f"block{parts[2]}", *tail], v
        if parts[0] == "upsample_layers":
            tail, v = _leaf("conv", param, value)
            return [f"upsample_layers_{parts[1]}", *tail], v
        if parts[0] == "seg_outputs":
            tail, v = _leaf("conv", param, value)
            return [f"seg_outputs_{parts[1]}", *tail[1:]], v
    elif parts[:2] == ["decoder", "transpconvs"]:
        return [f"decoder_transp_{parts[2]}", "kernel" if param == "weight" else "bias"], (
            value.transpose(2, 3, 4, 0, 1) if param == "weight" else value)
    elif parts[:2] == ["decoder", "seg_layers"]:
        tail, v = _leaf("conv", param, value)
        return [f"seg_output_{parts[2]}", *tail[1:]], v
    elif parts[1:2] == ["stages"] and parts[3] == "convs":
        # {encoder,decoder}.stages.{s}.convs.{i}.{conv,norm}.{weight,bias}
        tail, v = _leaf(parts[5], param, value)
        return [f"{parts[0]}_stage_{parts[2]}", f"conv{parts[4]}", *tail], v
    elif arch == "ResidualEncoderUNet" and parts[:2] == ["encoder", "stages"]:
        # encoder.stages.{s}.blocks.{b}.{conv1..3,norm1,2}.{weight,bias}
        tail, v = _leaf(parts[5], param, value)
        return [f"encoder_stage_{parts[2]}_block_{parts[4]}", *tail], v
    raise ValueError(f"not a {arch} parameter: {key}")


def state_dict_to_jax(arch_name: str, state_dict: Mapping) -> dict:
    """The port's state_dict of a network built by `build_network_from_plans`
    for `arch_name` -> the JAX package's parameter tree (nested dicts of fp32
    numpy arrays), the inverse of `state_dict_from_jax`."""
    arch = "STUNet" if arch_name.lower().startswith("stunet") else arch_name
    if arch not in ("STUNet", "PlainConvUNet", "ResidualEncoderUNet"):
        raise RuntimeError(f"Unknown network architecture {arch_name!r}")
    tree: dict = {}
    for key, t in state_dict.items():
        path, v = _jax_path(arch, key, t.detach().cpu().numpy())
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(v, np.float32)
    return tree

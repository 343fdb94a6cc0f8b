"""JAX parameters -> the port's state_dicts.

The input is a JAX package param tree as nested dicts of numpy arrays; the
output uses the reference torch models' names, so the JAX package's
`convert_torch_spark_state_dict` and `convert_torch_stunet_state_dict` are
the inverses of `spark_state_dict_from_jax` and `stunet_state_dict_from_jax`.

- conv kernels DHWIO -> OIDHW: transpose(4, 3, 0, 1, 2);
- ConvTranspose kernels (k, k, k, I, O), correlated un-flipped by
  lax.conv_transpose -> torch (I, O, k, k, k): flip the spatial axes, then
  transpose(3, 4, 0, 1, 2);
- mask tokens (C,) -> (1, C, 1, 1, 1); norm scale/bias -> weight/bias.
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


def _tensors(out: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}


def _res_stage(prefix: str, stage: Mapping, out: Dict[str, np.ndarray]) -> None:
    """One STUNet stage: block{b}/conv{1,2,3}/conv/{kernel,bias} and
    block{b}/norm{1,2}/{scale,bias} -> {prefix}.{b}.conv1.weight, ..."""
    for block_name, block in stage.items():
        pre = f"{prefix}.{block_name[len('block'):]}"
        for layer, node in block.items():
            if layer.startswith("conv"):
                out[f"{pre}.{layer}.weight"] = _conv(node["conv"]["kernel"])
                out[f"{pre}.{layer}.bias"] = np.asarray(node["conv"]["bias"])
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
            out[f"upsample_layers.{i}.conv.weight"] = _conv(node["conv"]["conv"]["kernel"])
            out[f"upsample_layers.{i}.conv.bias"] = np.asarray(node["conv"]["conv"]["bias"])
        elif kind == "seg_outputs":
            out[f"seg_outputs.{i}.weight"] = _conv(node["conv"]["kernel"])
            out[f"seg_outputs.{i}.bias"] = np.asarray(node["conv"]["bias"])
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
            out[f"densify_projs.{i}.weight"] = _conv(node["conv"]["kernel"])
            out[f"densify_projs.{i}.bias"] = np.asarray(node["conv"]["bias"])
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

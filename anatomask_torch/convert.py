"""JAX SparK parameters -> the port's state_dict.

The input is the JAX package's SparK param tree as nested dicts of numpy
arrays; the output uses the reference torch SparK's names, so the JAX
package's `convert_torch_spark_state_dict` is this function's inverse.

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


def spark_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    for stage_name, stage in params["sparse_encoder"].items():
        d = stage_name.rsplit("_", 1)[1]
        for block_name, block in stage.items():
            prefix = f"sparse_encoder.sp_cnn.conv_blocks_context.{d}.{block_name[len('block'):]}"
            for layer, node in block.items():
                if layer.startswith("conv"):
                    out[f"{prefix}.{layer}.weight"] = _conv(node["conv"]["kernel"])
                    out[f"{prefix}.{layer}.bias"] = np.asarray(node["conv"]["bias"])
                else:
                    _norm(f"{prefix}.{layer}", node, out)
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
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}

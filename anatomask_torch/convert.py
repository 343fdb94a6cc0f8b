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

SparK and the pretraining modules convert both ways through rule tables
(`RULES`): each rule pairs a JAX path template with a state_dict key
template and a layout (conv, transposed conv, dense, vector, mask token), so
that every JAX leaf is one torch tensor and back. `from_jax(name, params)`
and `to_jax(name, state_dict)` apply the table `name`: "spark" (STUNet or
MedNeXt encoder, densify layers, LightDecoder), and the standalone
"light_decoder", "ds_decoder", "smim_decoder", "smim_two_decoder",
"convnext_block", "grn" and "norm".
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch


def _conv(k) -> np.ndarray:
    return np.asarray(k).transpose(4, 3, 0, 1, 2)


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


# --- rule tables: SparK and the pretraining modules, both ways ---------------------

_CONV, _CONVT, _DENSE, _VEC, _TOKEN = "conv", "convt", "dense", "vec", "token"
Rule = Tuple[str, str, str]  # (JAX path template, state_dict key template, layout)


def _layout_to_torch(kind: str, v: np.ndarray) -> np.ndarray:
    if kind == _CONV:
        return v.transpose(4, 3, 0, 1, 2)
    if kind == _CONVT:
        return np.flip(v, (0, 1, 2)).transpose(3, 4, 0, 1, 2)
    if kind == _DENSE:
        return v.T
    return v.reshape(1, -1, 1, 1, 1) if kind == _TOKEN else v


def _layout_to_jax(kind: str, v: np.ndarray) -> np.ndarray:
    if kind == _CONV:
        return v.transpose(2, 3, 4, 1, 0)
    if kind == _CONVT:
        return np.flip(v.transpose(2, 3, 4, 0, 1), (0, 1, 2))
    if kind == _DENSE:
        return v.T
    return v.reshape(-1) if kind == _TOKEN else v


def _affine_rules(jax: str, torch_: str) -> List[Rule]:
    """A norm's scale/bias <-> weight/bias."""
    return [(f"{jax}scale", f"{torch_}weight", _VEC), (f"{jax}bias", f"{torch_}bias", _VEC)]


def _conv_rules(jax: str, torch_: str, kind: str = _CONV) -> List[Rule]:
    """A conv's kernel/bias <-> weight/bias (JAX's ConvND nests them under
    'conv/', which `jax` then ends with)."""
    return [(f"{jax}kernel", f"{torch_}weight", kind), (f"{jax}bias", f"{torch_}bias", _VEC)]


def _prefixed(rules: List[Rule], jax: str, torch_: str) -> List[Rule]:
    return [(jax + j, torch_ + t, k) for j, t, k in rules]


_UNET_BLOCK = (_conv_rules("up_sample/conv/", "up_sample.", _CONVT)
               + [("conv0/kernel", "conv.0.weight", _CONV), ("conv1/kernel", "conv.3.weight", _CONV)]
               + _affine_rules("norm0/", "conv.1.") + _affine_rules("norm1/", "conv.4."))
_LIGHT_DECODER = _prefixed(_UNET_BLOCK, "dec{i}/", "dec.{i}.") + _conv_rules("proj/", "proj.")
_STUNET_ENCODER = (_conv_rules("{c:conv\\d}/conv/", "{c}.") + _affine_rules("{n:norm\\d}/", "{n}."))
_MEDNEXT_BLOCK = _conv_rules("{c:conv\\d|res_conv}/", "{c}.") + _affine_rules("norm/", "norm.")
_MEDNEXT_ENCODER = (_conv_rules("stem/", "stem.")
                    + _prefixed(_MEDNEXT_BLOCK, "enc_block_{s}_{b}/", "enc_block_{s}.{b}.")
                    + _prefixed(_MEDNEXT_BLOCK, "down_{s}/", "down_{s}.")
                    + _prefixed(_MEDNEXT_BLOCK, "bottleneck_{b}/", "bottleneck.{b}."))

RULES: Dict[str, List[Rule]] = {
    "spark": (_prefixed(_STUNET_ENCODER, "sparse_encoder/conv_blocks_context_{d}/block{b}/",
                        "sparse_encoder.sp_cnn.conv_blocks_context.{d}.{b}.")
              + _prefixed(_MEDNEXT_ENCODER, "sparse_encoder/", "sparse_encoder.sp_cnn.")
              + _affine_rules("densify_norm{i}/", "densify_norms.{i}.")
              + _conv_rules("densify_proj{i}/conv/", "densify_projs.{i}.")
              + [("mask_token{i}", "mask_tokens.{i}", _TOKEN)]
              + _prefixed(_LIGHT_DECODER, "dense_decoder/", "dense_decoder.")),
    "light_decoder": _LIGHT_DECODER,
    "ds_decoder": (_prefixed(_UNET_BLOCK, "dec{i}/", "dec.{i}.")
                   + _conv_rules("ds_proj{i}/", "ds_projs.{i}.")),
    "smim_decoder": _conv_rules("up/", "up.", _CONVT) + _conv_rules("proj/", "proj."),
    "smim_two_decoder": _conv_rules("up{i}/", "ups.{i}.", _CONVT) + _conv_rules("proj/", "proj."),
    "convnext_block": (_conv_rules("dwconv/", "dwconv.") + _affine_rules("norm/", "norm.")
                       + _conv_rules("pwconv1/", "pwconv1.", _DENSE)
                       + _conv_rules("pwconv2/", "pwconv2.", _DENSE) + [("gamma", "gamma", _VEC)]),
    "grn": [("gamma", "gamma", _VEC), ("beta", "beta", _VEC)],
    "norm": _affine_rules("", ""),
}

_FIELD = re.compile(r"\{(\w+)(?::([^}]*))?\}")


def _rule_regex(rule: Rule, side: int) -> "re.Pattern":
    """The regex of rule[side]: a field {name} matches digits, {name:regex}
    (written in either template of the rule) the regex; the rest literally."""
    fields = {m[1]: m[2] for t in rule[:2] for m in _FIELD.finditer(t) if m[2]}
    out, pos = "", 0
    for m in _FIELD.finditer(rule[side]):
        out += (re.escape(rule[side][pos:m.start()])
                + f"(?P<{m[1]}>{fields.get(m[1], '[0-9]+')})")
        pos = m.end()
    return re.compile(out + re.escape(rule[side][pos:]))


def _apply_rules(rules: List[Rule], flat: Mapping[str, np.ndarray], side: int,
                 layout) -> Dict[str, np.ndarray]:
    """Each entry of `flat`, keyed by the rules' `side` (0 JAX, 1 torch),
    renamed to the other side by the first rule whose template matches it."""
    out = {}
    for key, v in flat.items():
        for rule in rules:
            m = _rule_regex(rule, side).fullmatch(key)
            if m:
                out[_FIELD.sub(lambda f: m[f[1]], rule[1 - side])] = layout(rule[2], v)
                break
        else:
            raise ValueError(f"no conversion rule for {key!r}")
    return out


def from_jax(name: str, params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX params of a module of RULES[name] -> the port's state_dict."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(params, "")
    return _tensors(_apply_rules(RULES[name], flat, 0, _layout_to_torch))


def to_jax(name: str, state_dict: Mapping) -> dict:
    """The port's state_dict of a module of RULES[name] -> its JAX params
    (nested dicts of fp32 numpy arrays), the inverse of `from_jax`. Buffers
    (running statistics) are not parameters and stay behind."""
    flat = {k: t.detach().cpu().numpy() for k, t in state_dict.items()
            if not k.endswith(("running_mean", "running_var"))}
    tree: dict = {}
    for path, v in _apply_rules(RULES[name], flat, 1, _layout_to_jax).items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v, np.float32)
    return tree


def spark_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX SparK's params -> the port's SparK state_dict."""
    return from_jax("spark", params)

"""The port's loaders of the reference's PyTorch checkpoints against the JAX
package's: seeded state_dicts in the reference's layouts (STUNet, SparK with
'module.' and 'sp_cnn.' nesting, PlainConvUNet with ConvDropoutNormReLU's
second spelling, ResidualEncoderUNet), merged into a network by each
package's load_torch_pretrained_weights under every variant. JAX's result,
carried over by convert.state_dict_from_jax, must equal the port's tensor
for tensor (both are copies of the same fp32 values). Also the stem's
channel expansion, the SparK key map, and the weights_only refusal of a
pickled file."""
import numpy as np
import pytest
import torch

from anatomask_tpu.training import checkpoint as jckpt
from anatomask_torch.convert import from_jax, state_dict_from_jax, state_dict_to_jax
from anatomask_torch.models.plain_unet import PlainConvUNet, ResidualEncoderUNet
from anatomask_torch.models.stunet import STUNet
from anatomask_torch.ssl.pretrain import PretrainConfig, build_spark_model
from anatomask_torch.training import checkpoint as tckpt

K3 = [[3, 3, 3]] * 3
STRIDES = [[1, 1, 1], [2, 2, 2], [2, 2, 2]]


def _networks():
    gen = torch.Generator().manual_seed(0)
    return {
        "STUNet": STUNet(1, 3, depth=(1, 2, 1), dims=(4, 8, 16), generator=gen),
        "PlainConvUNet": PlainConvUNet(1, 3, 3, (4, 8, 16), K3, STRIDES, (2, 2, 2), (2, 2),
                                       generator=gen),
        "ResidualEncoderUNet": ResidualEncoderUNet(1, 3, 3, (4, 8, 16), K3, STRIDES, (1, 2, 2),
                                                   (1, 1), generator=gen),
    }


def _seeded(keys_shapes, seed):
    rs = np.random.RandomState(seed)
    return {k: torch.tensor(rs.standard_normal(s).astype(np.float32)) for k, s in keys_shapes}


def _reference_layout(arch, sd, seed):
    """A reference checkpoint's state_dict for the port's network `sd`,
    other values from `seed`."""
    ref = _seeded([(k, v.shape) for k, v in sd.items()], seed)
    if arch == "PlainConvUNet":
        # ConvDropoutNormReLU registers conv and norm twice; the decoder holds
        # the encoder too
        for k in list(ref):
            for layer, idx in ((".conv.", ".all_modules.0."), (".norm.", ".all_modules.2.")):
                if ".convs." in k and layer in k:
                    ref[k.replace(layer, idx)] = ref[k]
            if k.startswith("encoder."):
                ref["decoder." + k] = ref[k]
    elif arch == "ResidualEncoderUNet":
        renamed = {}
        for k, v in ref.items():
            for port_name, ref_name in ((".conv1.", ".conv1.conv."), (".conv2.", ".conv2.conv."),
                                        (".norm1.", ".conv1.norm."), (".norm2.", ".conv2.norm."),
                                        (".conv3.", ".skip.1.conv.")):
                if k.startswith("encoder.") and port_name in k:
                    k = k.replace(port_name, ref_name)
                    break
            renamed[k] = v
        ref = renamed
    return ref


def _spark_layout(stunet_ref, seed):
    """A SparK pretraining checkpoint around a STUNet encoder: under DDP's
    'module.', the encoder in 'sparse_encoder.sp_cnn.', and decoder tensors
    that no supervised network has."""
    out = {f"module.sparse_encoder.sp_cnn.{k}": v for k, v in stunet_ref.items()
           if k.startswith("conv_blocks_context")}
    out.update({f"module.{k}": v for k, v in _seeded(
        [("dense_decoder.proj.weight", (1, 4, 1, 1, 1)), ("mask_tokens.0", (1, 16, 1, 1, 1))],
        seed).items()})
    return out


CASES = [
    ("STUNet", "stunet", "default", "plain"), ("STUNet", "stunet", "default", "spark"),
    ("STUNet", "stunet", "ssl", "spark"), ("STUNet", "stunet", "moco", "moco"),
    ("STUNet", "stunet", "swin", "plain"), ("STUNet", "stunet", "unimiss", "spark"),
    ("PlainConvUNet", "plain_unet", "default", "plain"),
    ("PlainConvUNet", "plain_unet", "swin", "module"),
    ("ResidualEncoderUNet", "resenc", "default", "plain"),
    ("ResidualEncoderUNet", "resenc", "unimiss", "module"),
]


@pytest.mark.parametrize("net,arch,variant,layout", CASES,
                         ids=["-".join(c[1:]) for c in CASES])
def test_load_torch_pretrained_weights_matches_jax(net, arch, variant, layout):
    sd = _networks()[net].state_dict()
    ref = _reference_layout(net, sd, seed=1)
    if layout == "spark":
        ref = _spark_layout(ref, seed=2)
    elif layout == "moco":
        ref = {f"module.encoder_q.net_q.{k}": v for k, v in ref.items()}
    elif layout == "module":
        ref = {f"module.{k}": v for k, v in ref.items()}

    j = state_dict_from_jax(net, jckpt.load_torch_pretrained_weights(
        state_dict_to_jax(net, sd), ref, variant=variant, arch=arch))
    t = tckpt.load_torch_pretrained_weights(sd, ref, variant=variant, arch=arch)
    assert t.keys() == sd.keys() == j.keys()
    changed = 0
    for k in sd:
        assert t[k].dtype == sd[k].dtype and torch.equal(t[k], j[k]), k
        changed += not torch.equal(t[k], sd[k])
    assert changed > 0


def test_no_transfer_raises_as_jax():
    sd = _networks()["STUNet"].state_dict()
    foreign = {"head.weight": torch.zeros(3, 3)}
    with pytest.raises(RuntimeError, match="no tensors transferred"):
        jckpt.load_torch_pretrained_weights(state_dict_to_jax("STUNet", sd), foreign)
    with pytest.raises(RuntimeError, match="no tensors transferred"):
        tckpt.load_torch_pretrained_weights(sd, foreign)


@pytest.mark.parametrize("target_in_channels", [2, 3])
def test_expand_input_channel_kernels_matches_jax(target_in_channels):
    sd = _networks()["STUNet"].state_dict()
    j = state_dict_from_jax("STUNet", jckpt.expand_input_channel_kernels(
        state_dict_to_jax("STUNet", sd), target_in_channels))
    t = tckpt.expand_input_channel_kernels(sd, target_in_channels)
    assert t.keys() == j.keys()
    for k in t:
        assert torch.equal(t[k], j[k]), k
    assert t["conv_blocks_context.0.0.conv1.weight"].shape[1] == target_in_channels


def test_spark_key_map_matches_jax():
    cfg = PretrainConfig(patch_size=(32, 32, 32), compute_dtype="float32",
                         encoder_dims=(4, 8, 16, 32, 64))
    sd = build_spark_model(cfg, 1, "cpu").state_dict()
    ref = {f"module.{k}": v for k, v in _seeded([(k, v.shape) for k, v in sd.items()], 3).items()}
    j = from_jax("spark", jckpt.convert_torch_spark_state_dict(ref))
    t = tckpt.convert_torch_spark_state_dict(ref)
    assert t.keys() == j.keys() == sd.keys()
    for k in t:
        assert torch.equal(t[k], j[k]), k


class _Pickled:
    """Not a tensor: torch.load(weights_only=True) refuses to build it."""


def test_pickled_file_needs_allow_pickle(tmp_path):
    sd = _networks()["STUNet"].state_dict()
    path = str(tmp_path / "legacy.pth")
    torch.save({"network_weights": sd, "trainer": _Pickled()}, path)
    for mod in (jckpt, tckpt):
        with pytest.raises(RuntimeError, match="allow_pickle=True"):
            mod.load_torch_checkpoint_file(path)
    j = jckpt.load_torch_checkpoint_file(path, allow_pickle=True)
    t = tckpt.load_torch_checkpoint_file(path, allow_pickle=True)
    assert t.keys() == j.keys() == sd.keys()
    assert all(torch.equal(t[k], sd[k]) for k in sd)
    safe = str(tmp_path / "weights.pth")
    torch.save({"state_dict": sd}, safe)
    loaded = tckpt.load_torch_pretrained_weights(
        {k: torch.zeros_like(v) for k, v in sd.items()}, safe)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd if "seg_outputs" not in k)

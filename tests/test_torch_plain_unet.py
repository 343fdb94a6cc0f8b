"""anatomask_torch's PlainConvUNet (instance and batch norm) and
ResidualEncoderUNet against anatomask_tpu's on the CPU in float32, on carried
weights: every deep-supervision head, the top head alone, the weight
conversion both ways through the JAX package's torch adapters, the
plans-driven build, and the conversion by architecture in the Predictor.
Inputs and weights come from numpy seeds and go to both."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.models.build import build_network_from_plans as jax_build
from anatomask_tpu.models.layers import SubpixelConvTranspose as JaxSubpixel
from anatomask_tpu.models.plain_unet import PlainConvUNet as JaxPlainConvUNet
from anatomask_tpu.models.plain_unet import ResidualEncoderUNet as JaxResidualEncoderUNet
from anatomask_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from anatomask_tpu.training.checkpoint import (convert_torch_plain_unet_state_dict,
                                               convert_torch_resenc_state_dict, flatten_tree,
                                               save_checkpoint)
from anatomask_torch.convert import (plain_unet_state_dict_from_jax, resenc_state_dict_from_jax,
                                     state_dict_from_jax)
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.models.layers import SubpixelConvTranspose
from anatomask_torch.models.plain_unet import PlainConvUNet, ResidualEncoderUNet
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.training import checkpoint as tck

from torch_parity import jax_random_params, to_ncdhw

# A tiny anisotropic topology: 4 stages, a pool of 1 on one axis, a (1, 3, 3)
# kernel at the bottom, unequal conv counts, 2 input channels, 3 classes.
FEATURES = (4, 8, 16, 16)
KERNELS = [[3, 3, 3]] * 3 + [[1, 3, 3]]
STRIDES = [[1, 1, 1], [2, 2, 2], [2, 2, 1], [1, 2, 2]]
N_CONV = (2, 1, 2, 1)
N_CONV_DEC = (1, 2, 2)
SHAPE = (12, 16, 8)
# fp32 through ~20 convs and norms, summed in other orders: max |diff| over
# max |ref|
REL = 1e-4


def rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _nets(arch, norm="instance", deep_supervision=True):
    common = dict(input_channels=2, num_classes=3, n_stages=4, features_per_stage=FEATURES,
                  kernel_sizes=KERNELS, strides=STRIDES, n_conv_per_stage_decoder=N_CONV_DEC,
                  deep_supervision=deep_supervision)
    if arch == "PlainConvUNet":
        return (JaxPlainConvUNet(n_conv_per_stage=N_CONV, norm=norm, **common),
                PlainConvUNet(n_conv_per_stage=N_CONV, norm=norm, **common))
    return (JaxResidualEncoderUNet(n_blocks_per_stage=N_CONV, **common),
            ResidualEncoderUNet(n_blocks_per_stage=N_CONV, **common))


CASES = [("PlainConvUNet", "instance"), ("PlainConvUNet", "batch"),
         ("ResidualEncoderUNet", "instance")]


@pytest.fixture(scope="module", params=CASES, ids=["plain", "plain-batchnorm", "resenc"])
def tiny(request):
    arch, norm = request.param
    jnet, net = _nets(arch, norm)
    params = jax_random_params(jnet, (2, *SHAPE, 2), seed=80)
    net.load_state_dict(state_dict_from_jax(arch, params), strict=True)
    return arch, norm, jnet, params, net.eval()


def test_every_head_matches_jax(tiny):
    _, _, jnet, params, net = tiny
    x = np.random.RandomState(81).rand(2, *SHAPE, 2).astype(np.float32)
    ref = jax.jit(lambda p, v: jnet.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_ncdhw(x))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 4, 1).numpy()
        assert g.shape == r.shape
        assert rel_err(g, np.asarray(r)) <= REL


def test_without_deep_supervision_only_the_top_head(tiny):
    arch, norm, _, _, net = tiny
    x = to_ncdhw(np.random.RandomState(82).rand(2, *SHAPE, 2).astype(np.float32))
    top = _nets(arch, norm, deep_supervision=False)[1].eval()
    top.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert torch.equal(top(x), net(x)[0])


def test_state_dict_round_trips_through_the_jax_adapters(tiny):
    arch, _, _, params, net = tiny
    adapter = (convert_torch_plain_unet_state_dict if arch == "PlainConvUNet"
               else convert_torch_resenc_state_dict)
    back = flatten_tree(adapter(net.state_dict()))
    ref = flatten_tree(params)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_converters_refuse_other_trees():
    with pytest.raises(ValueError, match="PlainConvUNet"):
        plain_unet_state_dict_from_jax({"conv_blocks_context_0": {}})
    with pytest.raises(ValueError, match="ResidualEncoderUNet"):
        resenc_state_dict_from_jax({"encoder_stage_0": {}})
    with pytest.raises(RuntimeError, match="architecture"):
        state_dict_from_jax("UNETR", {})


def test_batch_norm_uses_the_batch_statistics():
    """Under BatchNorm a sample's output depends on the rest of its batch,
    as in JAX; under InstanceNorm it does not."""
    x = to_ncdhw(np.random.RandomState(83).rand(2, *SHAPE, 2).astype(np.float32))
    for norm, coupled in (("batch", True), ("instance", False)):
        net = _nets("PlainConvUNet", norm, deep_supervision=False)[1].eval()
        with torch.no_grad():
            alone, together = net(x[:1]), net(x)[:1]
        assert (not torch.allclose(alone, together, atol=1e-4)) == coupled


@pytest.mark.parametrize("stride", [(2, 2, 2), (1, 2, 2)])
def test_transposed_conv_matches_jax(stride):
    """k = s transposed conv: matmul + pixel shuffle with the kernel mirrored
    as the JAX layer mirrors it, weight carried by the adapters' transpose."""
    rs = np.random.RandomState(84)
    x = rs.randn(2, 3, 4, 5, 6).astype(np.float32)
    kernel = rs.randn(*stride, 6, 5).astype(np.float32)
    bias = rs.randn(5).astype(np.float32)
    ref = JaxSubpixel(features=5, strides=stride).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x))
    layer = SubpixelConvTranspose(6, 5, stride)
    layer.load_state_dict({"weight": torch.tensor(kernel.transpose(3, 4, 0, 1, 2)),
                           "bias": torch.tensor(bias)})
    with torch.no_grad():
        got = layer(to_ncdhw(x))
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def _plans(arch):
    return {"dataset_name": "Dataset999_Tiny", "plans_name": "tinyPlans",
            "configurations": {"3d_fullres": {
                "patch_size": list(SHAPE), "UNet_class_name": arch,
                "UNet_base_num_features": 4, "unet_max_num_features": 12,
                "n_conv_per_stage_encoder": list(N_CONV),
                "n_conv_per_stage_decoder": list(N_CONV_DEC),
                "pool_op_kernel_sizes": STRIDES, "conv_kernel_sizes": KERNELS}}}


@pytest.mark.parametrize("arch,norm", CASES)
def test_build_from_plans_matches_jax_tree(arch, norm):
    """Features min(4 * 2^s, 12) from the plans: the port's network takes the
    JAX network's parameters strictly."""
    plans = _plans(arch)
    jpm = JaxPlansManager(plans)
    jnet = jax_build(jpm, jpm.get_configuration("3d_fullres"), 2, 3, norm=norm)
    pm = PlansManager(plans)
    net = build_network_from_plans(pm, pm.get_configuration("3d_fullres"), 2, 3, norm=norm,
                                   device="cpu")
    params = jax_random_params(jnet, (1, *SHAPE, 2), seed=85)
    net.load_state_dict(state_dict_from_jax(arch, params), strict=True)
    assert isinstance(net, PlainConvUNet if arch == "PlainConvUNet" else ResidualEncoderUNet)


@pytest.mark.parametrize("arch", ["PlainConvUNet", "ResidualEncoderUNet"])
def test_predictor_converts_by_architecture(tmp_path, arch):
    """A trained-model folder whose checkpoint names the architecture: the
    Predictor builds it and carries the JAX weights across; the port's own
    checkpoint writer gives the same file as the JAX package's."""
    plans = _plans(arch)
    (tmp_path / "plans.json").write_text(json.dumps(plans))
    (tmp_path / "dataset.json").write_text(json.dumps(
        {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "CT", "1": "MR"},
         "file_ending": ".nii.gz"}))
    jpm = JaxPlansManager(plans)
    jnet = jax_build(jpm, jpm.get_configuration("3d_fullres"), 2, 3, deep_supervision=False)
    params = jax_random_params(jnet, (1, *SHAPE, 2), seed=86)
    meta = {"configuration_name": "3d_fullres", "network_arch_name": arch,
            "inference_allowed_mirroring_axes": [0, 1, 2]}
    (tmp_path / "fold_0").mkdir()
    save_checkpoint(str(tmp_path / "fold_0" / "checkpoint_final.npz"),
                    {"network_weights": params}, meta)
    tck.save_checkpoint(str(tmp_path / "port.npz"), {"network_weights": params}, meta)
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "fold_0" / "checkpoint_final.npz") as ref:
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    pred = Predictor(device="cpu")
    pred.initialize_from_trained_model_folder(str(tmp_path))
    assert type(pred.network).__name__ == arch
    want = state_dict_from_jax(arch, params)
    got = pred.list_of_parameters[0]
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

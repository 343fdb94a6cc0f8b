"""anatomask_torch's STUNet against anatomask_tpu's on the CPU in float32, on
carried weights: the full network with deep supervision, nearest upsampling,
the weight conversion both ways, the plans-driven build (the U-Nets too),
and the port's copies of the plans (with their accessors), label and
checkpoint modules. Inputs and weights come
from numpy seeds and go to both."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.models import layers as jl
from anatomask_tpu.models.build import build_network_from_plans as jax_build
from anatomask_tpu.models.stunet import STUNet as JaxSTUNet
from anatomask_tpu.plans import label_handling as jlh
from anatomask_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from anatomask_tpu.training.checkpoint import (convert_torch_stunet_state_dict, flatten_tree,
                                               load_checkpoint as jax_load_checkpoint,
                                               save_checkpoint)
from anatomask_torch.convert import state_dict_from_jax, stunet_state_dict_from_jax
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.models.layers import upsample_nearest
from anatomask_torch.models.stunet import STUNet, stunet_preset
from anatomask_torch.plans import label_handling as tlh
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.training.checkpoint import load_checkpoint

from torch_parity import jax_random_params, to_ncdhw

# A tiny STUNet with an anisotropic topology: a two-block stage, pools of
# 1 on some axes and a (1, 3, 3) kernel at the bottom, whose 4x2x3 grid
# gives its norms 24 voxels a sample.
DIMS = (4, 8, 8, 16, 16, 16)
DEPTH = (1, 2, 1, 1, 1, 1)
POOLS = [(2, 2, 2), (2, 2, 2), (1, 2, 1), (1, 1, 1), (2, 1, 1)]
KERNELS = [(3, 3, 3)] * 5 + [(1, 3, 3)]
SHAPE = (16, 16, 12)
# fp32 through 23 convs and 22 norms, summed in other orders: max |diff|
# over max |ref| (measured about 8e-7)
REL = 1e-5


def rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny():
    jnet = JaxSTUNet(1, 3, depth=DEPTH, dims=DIMS, pool_op_kernel_sizes=POOLS,
                     conv_kernel_sizes=KERNELS)
    params = jax_random_params(jnet, (1, *SHAPE, 1), seed=50)
    net = STUNet(1, 3, DEPTH, DIMS, POOLS, KERNELS)
    net.load_state_dict(stunet_state_dict_from_jax(params), strict=True)
    return jnet, params, net


def test_stunet_matches_jax_every_head(tiny):
    jnet, params, net = tiny
    x = np.random.RandomState(51).rand(2, *SHAPE, 1).astype(np.float32)
    ref = jax.jit(lambda p, v: jnet.apply({"params": p}, v))(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(to_ncdhw(x))
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        g = g.permute(0, 2, 3, 4, 1).numpy()
        assert g.shape == r.shape
        assert rel_err(g, np.asarray(r)) <= REL


def test_without_deep_supervision_only_the_top_head(tiny):
    _, _, net = tiny
    x = to_ncdhw(np.random.RandomState(52).rand(1, *SHAPE, 1).astype(np.float32))
    top = STUNet(1, 3, DEPTH, DIMS, POOLS, KERNELS, deep_supervision=False)
    top.load_state_dict(net.state_dict())
    with torch.no_grad():
        assert torch.equal(top(x), net(x)[0])


def test_stunet_state_dict_round_trip(tiny):
    _, params, net = tiny
    back = flatten_tree(convert_torch_stunet_state_dict(net.state_dict()))
    ref = flatten_tree(params)
    assert set(back) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("scale", [(2, 2, 2), (1, 2, 3)])
def test_upsample_nearest_matches_jax(scale):
    x = np.random.RandomState(53).rand(2, 3, 4, 5, 6).astype(np.float32)
    ref = np.asarray(jl.upsample_nearest(jnp.asarray(x), scale))
    got = upsample_nearest(to_ncdhw(x), scale)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), ref)


def _plans(n_stages):
    """A plans dict whose 3d_fullres topology has n_stages stages."""
    pools = [[1, 1, 1]] + [[2, 2, 2]] * (n_stages - 1)
    return {"dataset_name": "Dataset999_Tiny", "plans_name": "tinyPlans",
            "configurations": {
                "base": {"patch_size": [16, 16, 16], "conv_kernel_sizes": [[3, 3, 3]] * n_stages,
                         "UNet_class_name": "PlainConvUNet"},
                "3d_fullres": {"inherits_from": "base", "pool_op_kernel_sizes": pools,
                               "UNet_class_name": "STUNet-S"}}}


@pytest.mark.parametrize("n_stages", [3, 8])
def test_build_from_plans_matches_jax_tree(n_stages):
    """Short plans are extended to STUNet's 6 stages, long ones cut, as in
    JAX: the port's network takes the JAX network's parameters strictly."""
    plans = _plans(n_stages)
    jnet = jax_build(JaxPlansManager(plans), JaxPlansManager(plans).get_configuration(
        "3d_fullres"), 1, 2, deep_supervision=False)
    pm = PlansManager(plans)
    net = build_network_from_plans(pm, pm.get_configuration("3d_fullres"), 1, 2,
                                   deep_supervision=False, device="cpu")
    params = jax_random_params(jnet, (1, 32, 32, 32, 1), seed=54)
    net.load_state_dict(stunet_state_dict_from_jax(params), strict=True)


@pytest.mark.parametrize("arch", ["PlainConvUNet", "ResidualEncoderUNet"])
def test_build_refuses_architectures_not_ported(arch):
    """Both architectures are ported now: each builds from the plans as the
    JAX package's does, and takes its parameters strictly."""
    plans = _plans(3)
    plans["configurations"]["base"].update(
        UNet_base_num_features=4, unet_max_num_features=8, n_conv_per_stage_encoder=[1, 2, 1],
        n_conv_per_stage_decoder=[1, 1])
    jpm, pm = JaxPlansManager(plans), PlansManager(plans)
    jnet = jax_build(jpm, jpm.get_configuration("3d_fullres"), 1, 2, arch_name=arch)
    net = build_network_from_plans(pm, pm.get_configuration("3d_fullres"), 1, 2, arch_name=arch,
                                   device="cpu")
    assert type(net).__name__ == type(jnet).__name__ == arch
    params = jax_random_params(jnet, (1, 16, 16, 16, 1), seed=56)
    net.load_state_dict(state_dict_from_jax(arch, params), strict=True)


def test_stunet_preset_checks(monkeypatch):
    with pytest.raises(ValueError, match="preset"):
        stunet_preset("tiny", 1, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stunet_preset("small", 1, 2)


def test_plans_resolve_as_in_jax():
    plans = _plans(4)
    ref = JaxPlansManager(plans).get_configuration("3d_fullres")
    got = PlansManager(plans).get_configuration("3d_fullres")
    assert got.configuration == ref.configuration
    assert got.UNet_class_name == ref.UNet_class_name == "STUNet-S"


@pytest.mark.parametrize("accessor", ["preprocessor_class", "resampling_fn_data",
                                      "image_reader_writer_class"])
def test_accessors_of_modules_not_ported_raise(accessor):
    """The three accessors reach ported modules now: each returns the port's
    counterpart of the JAX package's class or function (with the same
    kwargs), and raises nothing."""
    plans = dict(_plans(3), image_reader_writer="NibabelIO")
    plans["configurations"]["base"].update(
        preprocessor_name="DefaultPreprocessor",
        resampling_fn_data="resample_data_or_seg_to_shape",
        resampling_fn_data_kwargs={"is_seg": False, "order": 3, "force_separate_z": None})
    pm, jpm = PlansManager(plans), JaxPlansManager(plans)
    if accessor == "image_reader_writer_class":
        owner, ref_owner = pm, jpm
    else:
        owner, ref_owner = pm.get_configuration("3d_fullres"), jpm.get_configuration("3d_fullres")
    got, ref = getattr(owner, accessor), getattr(ref_owner, accessor)
    if accessor == "resampling_fn_data":
        assert got.keywords == ref.keywords
        got, ref = got.func, ref.func
    assert got.__name__ == ref.__name__
    assert got.__module__ == ref.__module__.replace("anatomask_tpu", "anatomask_torch")


@pytest.mark.parametrize("labels,order", [
    ({"background": 0, "a": 1, "b": 2}, None),
    ({"background": 0, "whole": [1, 2], "core": 2}, [1, 2]),
])
def test_label_manager_matches_jax(labels, order):
    logits = np.random.RandomState(55).randn(2 if order else 3, 4, 5, 6).astype(np.float32)
    ref = jlh.LabelManager(labels, order)
    got = tlh.LabelManager(labels, order)
    assert got.num_segmentation_heads == ref.num_segmentation_heads
    assert got.foreground_labels == ref.foreground_labels
    np.testing.assert_array_equal(got.convert_logits_to_segmentation(logits),
                                  ref.convert_logits_to_segmentation(logits))


def test_load_checkpoint_reads_what_jax_wrote(tmp_path):
    arrays = {"network_weights": {"a": {"kernel": np.arange(6.0).reshape(2, 3)}},
              "losses": [np.float32(1.5), np.arange(3)]}
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, arrays, {"network_arch_name": "STUNet-S", "axes": [0, 1, 2]})
    got, meta = load_checkpoint(path)
    ref, ref_meta = jax_load_checkpoint(path)
    assert meta == ref_meta
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(g, r)

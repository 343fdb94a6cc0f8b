"""Weights and metrics across the two packages on the CPU: AnatoMask's encoder
transfer and the pretrained-weight merge against the JAX functions, tensor
for tensor; the inverse converters (the port's state_dicts -> the JAX
layout) round trip bit for bit with `state_dict_from_jax`; deep supervision
and the norm reach the networks `build_network_from_plans` makes; and
`compute_metrics_on_folder` against JAX on the same files."""
import json
import os

import numpy as np
import jax
import pytest
import torch

from anatomask_tpu.evaluation.metrics import compute_metrics_on_folder as jax_metrics
from anatomask_tpu.imageio.nifti import NiftiIO as JaxNiftiIO
from anatomask_tpu.imageio.nifti import write_nifti
from anatomask_tpu.models.stunet import STUNet as JaxSTUNet
from anatomask_tpu.training import checkpoint as jck
from anatomask_torch.convert import (spark_state_dict_from_jax, state_dict_from_jax,
                                     state_dict_to_jax, stunet_state_dict_from_jax)
from anatomask_torch.evaluation.metrics import compute_metrics_on_folder
from anatomask_torch.imageio.nifti import NiftiIO
import anatomask_torch.models.stunet as port_stunet
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.models.layers import BatchNorm, InstanceNorm
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.training import checkpoint as tck

import test_torch_plain_unet as plain
from torch_parity import jax_build_spark_model, jax_random_params, tiny_configs

# the tiny STUNet whose encoder the tiny SparK's matches (dims 4..64)
DIMS = (4, 8, 16, 32, 64, 64)
POOLS = [(2, 2, 2)] * 4 + [(1, 1, 1)]


def _jax_stunet(seed, classes=3, deep_supervision=True):
    net = JaxSTUNet(1, classes, dims=DIMS, pool_op_kernel_sizes=POOLS,
                    deep_supervision=deep_supervision)
    return jax_random_params(net, (1, 32, 32, 32, 1), seed)


def _equal_trees(got: dict, want: dict):
    got, want = jck.flatten_tree(got), jck.flatten_tree(want)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def _equal_state_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), k


def tiny_spark_params(seed):
    """A tiny SparK's JAX parameters (encoder dims 4..64), drawn with numpy."""
    model = jax_build_spark_model(tiny_configs()[0])
    return jax_random_params(model, (1, *model.input_size, 1), seed,
                             model.mask(jax.random.PRNGKey(0), 1))


@pytest.fixture(scope="module")
def spark_params():
    return tiny_spark_params(40)


def test_transfer_ssl_encoder_matches_jax(spark_params):
    """Every encoder tensor of the pretrained SparK replaces the STUNet's,
    the decoder and heads stay: the same STUNet as JAX's, tensor for tensor."""
    stunet = _jax_stunet(41)
    want = jck.transfer_ssl_encoder_weights(stunet, spark_params["sparse_encoder"])
    got = tck.transfer_ssl_encoder_weights(stunet_state_dict_from_jax(stunet),
                                           spark_state_dict_from_jax(spark_params))
    _equal_state_dicts(got, stunet_state_dict_from_jax(want))
    before = stunet_state_dict_from_jax(stunet)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    assert moved and all(k.startswith("conv_blocks_context.") for k in moved)
    assert not any(k.startswith("conv_blocks_context.5.") for k in moved)  # no 6th stage


def test_load_pretrained_weights_matches_jax():
    """Name- and shape-matched merge without the seg heads (another class
    count: the heads differ in shape and are skipped)."""
    params, pretrained = _jax_stunet(42), _jax_stunet(43, classes=5)
    want = jck.load_pretrained_weights(params, pretrained)
    got = tck.load_pretrained_weights(stunet_state_dict_from_jax(params),
                                      stunet_state_dict_from_jax(pretrained))
    _equal_state_dicts(got, stunet_state_dict_from_jax(want))
    other = {"conv_blocks_context.0.0.conv1.weight": torch.zeros(4, 2, 3, 3, 3)}
    with pytest.raises(ValueError, match="Shape mismatch"):
        tck.load_pretrained_weights(stunet_state_dict_from_jax(params), other)


def _plain_params(arch, norm):
    jnet, _ = plain._nets(arch, norm)
    return jax_random_params(jnet, (2, *plain.SHAPE, 2), seed=44)


@pytest.mark.parametrize("case", ["STUNet-B", "STUNet-nods", "PlainConvUNet",
                                  "PlainConvUNet-batch", "ResidualEncoderUNet"])
def test_state_dict_to_jax_round_trips(case):
    """JAX params -> the port -> JAX, and the port's state_dict -> JAX -> the
    port, bit for bit (STUNet with its five deep-supervision heads)."""
    if case.startswith("STUNet"):
        arch, params = "STUNet-B", _jax_stunet(45, deep_supervision=case == "STUNet-B")
        assert len([k for k in params if k.startswith("seg_outputs_")]) == 5
    else:
        arch = case.split("-")[0]
        params = _plain_params(arch, "batch" if case.endswith("batch") else "instance")
    sd = state_dict_from_jax(arch, params)
    _equal_trees(state_dict_to_jax(arch, sd), params)
    _equal_state_dicts(state_dict_from_jax(arch, state_dict_to_jax(arch, sd)), sd)


def test_state_dict_to_jax_refuses_other_names():
    with pytest.raises(ValueError, match="not a PlainConvUNet parameter"):
        state_dict_to_jax("PlainConvUNet", {"conv_blocks_context.0.0.conv1.weight":
                                            torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Unknown network architecture"):
        state_dict_to_jax("UNETR", {})


@pytest.mark.parametrize("arch", ["STUNet-B", "PlainConvUNet", "ResidualEncoderUNet"])
def test_build_passes_deep_supervision_and_norm(arch, monkeypatch):
    """deep_supervision reaches every architecture (one head's logits, or
    every head's: STUNet's five); norm='batch' reaches PlainConvUNet, whose
    norms become BatchNorm, as in the JAX build. STUNet-B's preset narrowed
    to dims 4..64."""
    monkeypatch.setitem(port_stunet._PRESETS, "base", (4, (1,) * 6))
    plans = plain._plans("PlainConvUNet" if arch == "STUNet-B" else arch)
    plans["configurations"]["3d_fullres"]["pool_op_kernel_sizes"] = [[1, 1, 1], [2, 2, 2],
                                                                     [2, 2, 2], [2, 2, 2]]
    plans["configurations"]["3d_fullres"]["conv_kernel_sizes"] = [[3, 3, 3]] * 4
    pm = PlansManager(plans)
    cm = pm.get_configuration("3d_fullres")
    x = torch.rand(1, 2, 16, 16, 16).contiguous(memory_format=torch.channels_last_3d)
    n_heads = 5 if arch == "STUNet-B" else 3
    for ds in (True, False):
        net = build_network_from_plans(pm, cm, 2, 3, arch_name=arch, deep_supervision=ds,
                                       device="cpu", norm="batch")
        with torch.no_grad():
            out = net(x)
        assert (len(out) == n_heads) if ds else isinstance(out, torch.Tensor)
        norms = {type(m) for m in net.modules() if isinstance(m, InstanceNorm)}
        assert norms == ({BatchNorm} if arch == "PlainConvUNet" else {InstanceNorm})


def _write_cases(folder, segs, spacing=(1.0, 1.0, 1.0)):
    os.makedirs(folder, exist_ok=True)
    for name, seg in segs.items():
        write_nifti(os.path.join(folder, name + ".nii.gz"), seg.astype(np.uint8),
                    spacing_xyz=spacing)


@pytest.mark.parametrize("labels,ignore", [([1, 2, 3], None), ([1, 2, 3], 4),
                                           ([(1, 2, 3), (2, 3), 3], None)])
def test_compute_metrics_on_folder_matches_jax(tmp_path, labels, ignore):
    """The same reference and prediction files: every per-case metric, the
    means and summary.json equal (a class absent from a case gives NaN
    Dice, written as null)."""
    rs = np.random.RandomState(46)
    ref = {f"case_{i}": rs.randint(0, 5 if ignore else 4, (12, 10, 8)) for i in range(3)}
    pred = {k: np.where(rs.rand(*v.shape) < 0.2, rs.randint(0, 4, v.shape), v)
            for k, v in ref.items()}
    ref["case_2"][ref["case_2"] == 3] = 0
    pred["case_2"][pred["case_2"] == 3] = 0
    _write_cases(str(tmp_path / "ref"), ref)
    _write_cases(str(tmp_path / "pred"), pred)
    args = [str(tmp_path / "ref"), str(tmp_path / "pred")]
    want = jax_metrics(*args, str(tmp_path / "jax.json"), JaxNiftiIO(), ".nii.gz", labels, ignore)
    got = compute_metrics_on_folder(*args, str(tmp_path / "port.json"), NiftiIO(), ".nii.gz",
                                    labels, ignore, num_processes=2)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    np.testing.assert_equal(got["mean"], want["mean"])
    np.testing.assert_equal(got["foreground_mean"], want["foreground_mean"])
    assert [c["metrics"] for c in got["metric_per_case"]] == pytest.approx(
        [c["metrics"] for c in want["metric_per_case"]], nan_ok=True)

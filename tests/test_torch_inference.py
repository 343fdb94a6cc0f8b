"""anatomask_torch.inference against anatomask_tpu.inference on the CPU in
float32: the Gaussian, the tile steps and the padding (exact), the mirror-TTA
tile function and both sliding-window paths with a tiny STUNet on carried
weights over a small odd volume, and the Predictor reading a trained-model
folder that the JAX package's checkpoint writer filled (two folds)."""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from anatomask_tpu.inference import gaussian as jg
from anatomask_tpu.inference import sliding_window as jsw
from anatomask_tpu.inference.predictor import Predictor as JaxPredictor
from anatomask_tpu.models.build import build_network_from_plans as jax_build
from anatomask_tpu.models.stunet import STUNet as JaxSTUNet
from anatomask_tpu.plans.plans_handler import PlansManager as JaxPlansManager
from anatomask_tpu.training.checkpoint import save_checkpoint
from anatomask_torch.convert import stunet_state_dict_from_jax
from anatomask_torch.inference import gaussian as tg
from anatomask_torch.inference import sliding_window as tsw
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.models.stunet import STUNet

from torch_parity import jax_random_params

# max |diff| / max |ref| of logits after a tiny fp32 STUNet, the TTA average
# and the Gaussian blend, sums taken in other orders
REL = 1e-4
# the tiny STUNet of tests/test_torch_stunet.py without deep supervision
DIMS = (4, 8, 8, 16, 16, 16)
DEPTH = (1, 2, 1, 1, 1, 1)
POOLS = [(2, 2, 2), (2, 2, 2), (1, 2, 1), (1, 1, 1), (2, 1, 1)]
KERNELS = [(3, 3, 3)] * 5 + [(1, 3, 3)]
TILE = (16, 16, 12)
# odd on every axis: two tiles along x and z, y padded up to the tile
VOLUME = (1, 21, 13, 15)


def rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("tile", [(16, 16, 12), (5, 7, 9), (128, 128, 128)])
def test_gaussian_is_the_jax_gaussian(tile):
    np.testing.assert_array_equal(tg.compute_gaussian(tile, value_scaling_factor=1000.0),
                                  jg.compute_gaussian(tile, value_scaling_factor=1000.0))


@pytest.mark.parametrize("image,tile,step", [
    ((240, 240, 155), (128, 128, 128), 0.5), ((21, 16, 15), (16, 16, 12), 0.5),
    ((100, 37, 64), (32, 32, 64), 0.33), ((64, 64, 64), (64, 64, 64), 1.0)])
def test_steps_are_the_jax_steps(image, tile, step):
    assert (tsw.compute_steps_for_sliding_window(image, tile, step)
            == jsw.compute_steps_for_sliding_window(image, tile, step))


@pytest.mark.parametrize("shape,new", [((1, 21, 13, 15), (16, 16, 12)), ((2, 5, 6, 7), (8, 6, 4))])
def test_padding_is_the_jax_padding(shape, new):
    data = np.random.RandomState(60).rand(*shape).astype(np.float32)
    got, got_sl = tsw.pad_nd_image(data, new)
    ref, ref_sl = jsw.pad_nd_image(data, new)
    np.testing.assert_array_equal(got, ref)
    assert got_sl == ref_sl


@pytest.fixture(scope="module")
def nets():
    jnet = JaxSTUNet(1, 3, depth=DEPTH, dims=DIMS, pool_op_kernel_sizes=POOLS,
                     conv_kernel_sizes=KERNELS, deep_supervision=False)
    params = jax_random_params(jnet, (1, *TILE, 1), seed=61)
    net = STUNet(1, 3, DEPTH, DIMS, POOLS, KERNELS, deep_supervision=False).eval()
    net.load_state_dict(stunet_state_dict_from_jax(params), strict=True)

    def jax_apply(x):
        return jnet.apply({"params": params}, x)

    def port_apply(x):
        return net(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)

    return jax_apply, port_apply


@pytest.mark.parametrize("axes", [None, (1,), (0, 1, 2)])
def test_tta_tile_function_matches_jax(nets, axes):
    jax_apply, port_apply = nets
    x = np.random.RandomState(62).rand(2, *TILE, 1).astype(np.float32)
    ref = jax.jit(jsw.make_tile_predictor(jax_apply, axes))(jnp.asarray(x))
    with torch.no_grad():
        got = tsw.make_tile_predictor(port_apply, axes)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_err(got.numpy(), np.asarray(ref)) <= REL


@pytest.mark.parametrize("path", ["device_resident", "streaming"])
def test_sliding_window_matches_jax(nets, path):
    """Four tiles in batches of 3: both packages pad the last batch with
    zero-weight duplicates of its one tile."""
    jax_apply, port_apply = nets
    data = np.random.RandomState(63).rand(*VOLUME).astype(np.float32)
    axes = (0, 1, 2)
    if path == "device_resident":
        ref = jsw.sliding_window_predict_device_resident(
            data, jsw.make_tile_predictor(jax_apply, axes), TILE, 3, tile_batch_size=3)
        got = tsw.sliding_window_predict_device_resident(
            data, tsw.make_tile_predictor(port_apply, axes), TILE, 3, tile_batch_size=3,
            device="cpu")
    else:
        ref = jsw.sliding_window_predict(
            data, jsw.make_tile_predictor(jax_apply, axes), TILE, 3, tile_batch_size=3)
        got = tsw.sliding_window_predict(
            data, tsw.make_tile_predictor(port_apply, axes), TILE, 3, tile_batch_size=3,
            device="cpu")
    assert got.shape == ref.shape == (3, *VOLUME[1:])
    assert rel_err(got, ref) <= REL


def test_sliding_window_without_gaussian_is_the_tile_mean():
    """With an identity network and flat weights, every voxel averages the
    tiles that cover it to the input itself."""
    data = np.random.RandomState(64).rand(2, 9, 7, 5).astype(np.float32)
    got = tsw.sliding_window_predict(data, lambda x: x, (4, 4, 4), 2, tile_step_size=0.5,
                                     use_gaussian=False, tile_batch_size=2, device="cpu")
    np.testing.assert_allclose(got, data, rtol=1e-6)


def _plans():
    return {"dataset_name": "Dataset999_Tiny", "plans_name": "tinyPlans",
            "configurations": {"3d_fullres": {
                "patch_size": [16, 16, 16], "UNet_class_name": "STUNet-S",
                "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
                "conv_kernel_sizes": [[3, 3, 3]] * 3}}}


@pytest.fixture(scope="module")
def model_folder(tmp_path_factory):
    """Two folds of a STUNet-S written by the JAX package's checkpoint writer,
    with the plans and dataset.json of a trained-model folder."""
    root = tmp_path_factory.mktemp("trained")
    plans = _plans()
    dataset = {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "CT"},
               "file_ending": ".nii.gz"}
    (root / "plans.json").write_text(json.dumps(plans))
    (root / "dataset.json").write_text(json.dumps(dataset))
    pm = JaxPlansManager(plans)
    jnet = jax_build(pm, pm.get_configuration("3d_fullres"), 1, 3, deep_supervision=False)
    meta = {"configuration_name": "3d_fullres", "inference_allowed_mirroring_axes": [0, 1, 2],
            "network_arch_name": "STUNet-S"}
    for fold in (0, 1):
        (root / f"fold_{fold}").mkdir()
        params = jax_random_params(jnet, (1, 16, 16, 16, 1), seed=70 + fold)
        save_checkpoint(str(root / f"fold_{fold}" / "checkpoint_final.npz"),
                        {"network_weights": params}, meta)
    return str(root)


def test_predictor_matches_jax_predictor(model_folder):
    data = np.random.RandomState(65).rand(1, 20, 18, 16).astype(np.float32)
    ref_pred = JaxPredictor()
    ref_pred.initialize_from_trained_model_folder(model_folder)
    ref = ref_pred.predict_sliding_window_return_logits(data)
    pred = Predictor(device="cpu")
    pred.initialize_from_trained_model_folder(model_folder)
    assert Predictor.auto_detect_available_folds(model_folder, "checkpoint_final.npz") == [0, 1]
    assert len(pred.list_of_parameters) == 2
    got = pred.predict_sliding_window_return_logits(data)
    assert got.shape == ref.shape == (3, 20, 18, 16)
    assert rel_err(got, ref) <= REL


def test_predictor_streams_volumes_over_the_budget(model_folder):
    """A volume over the device budget takes the streaming path, with the
    same result."""
    data = np.random.RandomState(66).rand(1, 20, 16, 16).astype(np.float32)
    pred = Predictor(device="cpu", use_mirroring=False)
    pred.initialize_from_trained_model_folder(model_folder, use_folds=[1])
    assert pred._fits_device_resident(data, 3, (16, 16, 16))
    assert not pred._fits_device_resident(data, 3, (16, 16, 16), budget_bytes=1024)
    resident = pred.predict_sliding_window_return_logits(data)
    streamed = tsw.sliding_window_predict(data, pred._tile_fn, (16, 16, 16), 3,
                                          tile_batch_size=2, device="cpu")
    np.testing.assert_allclose(streamed, resident, rtol=1e-6, atol=1e-6)

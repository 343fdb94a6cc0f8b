"""The port's supervised Trainer against the JAX package's on the CPU, on a
synthetic dataset written by the JAX planner and preprocessor: one training
step of a tiny STUNet with deep supervision (dims 4...64, 32^3, augmentation
off) for each optimizer on carried weights (loss, gradients, updated
parameters), the validation step's tp/fp/fn, do_split and _ds_factors, the
LR at epoch boundaries, the presets, a one-epoch run_training with its
checkpoints and a resume, and perform_actual_validation's summary.json."""
import os
import re
from dataclasses import asdict, replace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import anatomask_tpu.models.stunet as jax_stunet
import anatomask_torch.models.stunet as port_stunet
from anatomask_tpu.data.augment import make_train_augment_fn as jax_train_augment
from anatomask_tpu.inference.predictor import Predictor as JaxPredictor
from anatomask_tpu.plans.plans_handler import load_json, save_json
from anatomask_tpu.training import trainer as jax_trainer_mod
from anatomask_tpu.training.checkpoint import flatten_tree
from anatomask_torch.convert import state_dict_from_jax, state_dict_to_jax
from anatomask_torch.data.dataset import CaseDataset
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.training import trainer as port_trainer_mod
from anatomask_torch.training.trainer import Trainer, TrainerConfig
from synthetic import make_synthetic_dataset, setup_env
from torch_parity import jax_random_params

DATASET = "Dataset906_TSUP"
# a tiny STUNet: the 'base' preset's width multiplier 32 -> 4 (dims 4..64)
TINY_STUNET = (4, (1, 1, 1, 1, 1, 1))
PATCH = [32, 32, 32]
# grads: each leaf to this share of its own largest entry (tests/test_torch_step.py)
GRAD_RTOL = 7.1e-3
# conv biases right before an instance norm: exact gradient zero
CANCELLED = re.compile(r"conv_blocks_(context|localization)\.\d+\.\d+\.conv[12]\.bias")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("torch_supervised")
    raw, pp, _ = setup_env(tmp_path)
    make_synthetic_dataset(raw, DATASET, num_cases=6, shape=(20, 22, 24))
    from anatomask_tpu.planning.fingerprint import DatasetFingerprintExtractor
    from anatomask_tpu.planning.planner import ExperimentPlanner
    from anatomask_tpu.preprocessing.preprocessor import DefaultPreprocessor
    DatasetFingerprintExtractor(DATASET, num_processes=1).run()
    ExperimentPlanner(DATASET).plan_experiment()
    DefaultPreprocessor().run(DATASET, "3d_fullres", "ATKPlans", num_processes=1)
    plans_file = os.path.join(pp, DATASET, "ATKPlans.json")
    plans = load_json(plans_file)
    ident = plans["configurations"]["3d_fullres"]["data_identifier"]
    plans["configurations"]["tiny_stunet"] = {
        "inherits_from": "3d_fullres", "data_identifier": ident, "patch_size": PATCH,
        "batch_size": 2, "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 4 + [[1, 1, 1]],
        "conv_kernel_sizes": [[3, 3, 3]] * 6, "batch_dice": True}
    plans["configurations"]["tiny_plain"] = {
        "inherits_from": "3d_fullres", "data_identifier": ident, "patch_size": [16, 16, 16],
        "batch_size": 2, "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 8, "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
        "conv_kernel_sizes": [[3, 3, 3]] * 3, "n_conv_per_stage_encoder": [1, 1, 1],
        "n_conv_per_stage_decoder": [1, 1], "num_pool_per_axis": [2, 2, 2],
        "batch_dice": True}
    save_json(plans, plans_file, sort_keys=False)
    dataset_json = load_json(os.path.join(pp, DATASET, "dataset.json"))
    return tmp_path, plans_file, dataset_json


class _SeededInit:
    """A JAX network whose init draws its parameters with numpy from a seed
    (torch_parity.jax_random_params) instead of running flax's eager
    initialisation; apply is the network's."""

    def __init__(self, net):
        self.net = net

    def init(self, rng, example):
        return {"params": jax_random_params(self.net, example.shape, 48)}

    def apply(self, *args, **kw):
        return self.net.apply(*args, **kw)


@pytest.fixture(autouse=True)
def seeded_jax_init(monkeypatch):
    build = jax_trainer_mod.build_network_from_plans
    monkeypatch.setattr(jax_trainer_mod, "build_network_from_plans",
                        lambda *a, **kw: _SeededInit(build(*a, **kw)))


@pytest.fixture
def tiny_stunet(monkeypatch):
    monkeypatch.setitem(jax_stunet._PRESETS, "base", TINY_STUNET)
    monkeypatch.setitem(port_stunet._PRESETS, "base", TINY_STUNET)
    monkeypatch.setenv("ATK_NUM_DEVICES", "1")  # the JAX mesh: one CPU device


def _trainers(prepared, configuration, name, **kw):
    """The JAX and the port's Trainer on one configuration and output folder
    each, the port's network holding the JAX one's initial weights."""
    tmp_path, plans_file, dataset_json = prepared
    setup_env(tmp_path)
    cfg = TrainerConfig(name=name, compute_dtype="float32", num_workers=1, **kw)
    jt = jax_trainer_mod.Trainer(plans_file, configuration, 0, dataset_json,
                                 jax_trainer_mod.TrainerConfig(**asdict(cfg)),
                                 output_folder=os.path.join(str(tmp_path), "jax", name))
    jt.initialize()
    pt = Trainer(plans_file, configuration, 0, dataset_json, cfg,
                 output_folder=os.path.join(str(tmp_path), "port", name), device="cpu")
    pt.initialize()
    pt.network.load_state_dict(state_dict_from_jax(pt.arch_name, jax.device_get(jt.params)))
    return jt, pt


def _batch(seed, patch=PATCH, batch=2):
    rs = np.random.RandomState(seed)
    data = rs.standard_normal((batch, *patch, 1)).astype(np.float32)
    seg = rs.randint(0, 3, (batch, *patch, 1)).astype(np.int16)
    seg[:, :3] = -1  # the sampler's pad
    return data, seg


def _torch_sd(arch, tree):
    return state_dict_from_jax(arch, jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def jax_grads(prepared):
    """The JAX trainer's loss and gradients (augmentation off) at its initial
    weights, once for every optimizer."""
    with pytest.MonkeyPatch.context() as mp:
        build = jax_trainer_mod.build_network_from_plans
        mp.setattr(jax_trainer_mod, "build_network_from_plans",
                   lambda *a, **kw: _SeededInit(build(*a, **kw)))
        mp.setitem(jax_stunet._PRESETS, "base", TINY_STUNET)
        mp.setitem(port_stunet._PRESETS, "base", TINY_STUNET)
        mp.setenv("ATK_NUM_DEVICES", "1")
        jt, _ = _trainers(prepared, "tiny_stunet", "grads", arch_name="STUNet-B",
                          do_data_augmentation=False)
    data, seg = _batch(0)
    augment = jax_train_augment(jt.aug_config)

    def loss_fn(p):
        x, targets = augment(jax.random.PRNGKey(0), jnp.asarray(data), jnp.asarray(seg))
        return jt._full_loss(jt.network.apply({"params": p}, x), targets)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    clip = optax.clip_by_global_norm(12.0)
    clipped, _ = clip.update(grads, clip.init(grads))
    return float(loss), grads, clipped, jt.params


@pytest.mark.parametrize("optimizer", ["sgd", "adamw", "adam", "adan"])
def test_train_step_matches_jax(prepared, tiny_stunet, jax_grads, optimizer):
    """Loss to 1e-5, the clipped gradients to GRAD_RTOL of each leaf's largest
    entry (the global norm is above 12 here, so the clip acts), and
    the updated parameters: the JAX trainer's optax chain applied to the
    port's own gradients gives the port's new weights (atol 1e-6), and to
    JAX's gradients the JAX trainer's (the sgd case runs the jitted
    Trainer._train_step itself)."""
    ref_loss, ref_grads, ref_clipped, params = jax_grads
    jt, pt = _trainers(prepared, "tiny_stunet", f"step_{optimizer}", arch_name="STUNet-B",
                       do_data_augmentation=False, optimizer=optimizer,
                       initial_lr={"sgd": 1e-2, "adan": 1e-2}.get(optimizer, 3e-4))
    pt.network.load_state_dict(_torch_sd(pt.arch_name, params))
    data, seg = _batch(0)
    loss = pt.train_step(torch.from_numpy(data), torch.from_numpy(seg))
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)

    named = dict(pt.network.named_parameters())
    ref = _torch_sd(pt.arch_name, ref_clipped)
    assert set(ref) == set(named)
    g_max = max(r.abs().max().item() for r in ref.values())
    for name, r in ref.items():
        g = named[name].grad
        if CANCELLED.fullmatch(name):
            assert max(g.abs().max().item(), r.abs().max().item()) <= 1e-6 * g_max, name
        else:
            assert (g - r).abs().max().item() <= GRAD_RTOL * r.abs().max().item(), name

    # the law: JAX's optimizer on the port's (clipped) gradients
    port_grads = state_dict_to_jax(pt.arch_name, {n: p.grad for n, p in named.items()})
    updates, _ = jax.jit(jt.optimizer.update)(port_grads, jt.optimizer.init(params), params)
    law = _torch_sd(pt.arch_name, optax.apply_updates(params, updates))
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), law[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    if optimizer == "sgd":
        copy = jax.tree_util.tree_map(jnp.array, params)  # the step donates its inputs
        new, _, jloss = jt._train_step(copy, jt.optimizer.init(copy), jax.random.PRNGKey(0),
                                       jnp.asarray(data), jnp.asarray(seg))
        np.testing.assert_allclose(float(jloss), ref_loss, rtol=1e-6)
        updates, _ = jax.jit(jt.optimizer.update)(ref_grads, jt.optimizer.init(params), params)
        want = flatten_tree(jax.device_get(optax.apply_updates(params, updates)))
        for k, v in flatten_tree(jax.device_get(new)).items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)
    assert pt.step_counter == 1


def test_val_step_counts_equal_jax(prepared, tiny_stunet, jax_grads):
    params = jax_grads[-1]
    jt, pt = _trainers(prepared, "tiny_stunet", "val", arch_name="STUNet-B")
    pt.network.load_state_dict(_torch_sd(pt.arch_name, params))
    data, seg = _batch(1)
    ref = jt._val_step(params, jax.random.PRNGKey(0), jnp.asarray(data), jnp.asarray(seg))
    got = pt.val_step(torch.from_numpy(data), torch.from_numpy(seg))
    np.testing.assert_allclose(got[0].item(), float(ref[0]), rtol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_load_ssl_encoder_into_trainer_matches_jax(prepared, tiny_stunet, tmp_path):
    """A JAX pretraining checkpoint (.npz) and the port PretrainTrainer's
    (.pt) of the same tiny SparK give the port's STUNet the parameters that
    JAX's load_ssl_encoder_into_trainer gives the JAX one, tensor for
    tensor."""
    from anatomask_tpu.ssl.pretrain import load_ssl_encoder_into_trainer as jax_load
    from anatomask_tpu.training.checkpoint import save_checkpoint
    from anatomask_torch.convert import spark_state_dict_from_jax
    from anatomask_torch.ssl.pretrain import load_ssl_encoder_into_trainer
    from anatomask_torch.training.checkpoint import save_trainer_checkpoint
    from test_torch_transfer import tiny_spark_params
    spark = tiny_spark_params(47)
    save_checkpoint(str(tmp_path / "pretrain.npz"), {"network_weights": spark}, {})
    save_trainer_checkpoint(str(tmp_path / "pretrain.pt"),
                            {"network_weights": spark_state_dict_from_jax(spark)}, {})
    jt, pt = _trainers(prepared, "tiny_stunet", "ssl", arch_name="STUNet-B")
    before = {k: v.clone() for k, v in pt.network.state_dict().items()}
    jax_load(jt, str(tmp_path / "pretrain.npz"), verbose=False)
    want = _torch_sd(pt.arch_name, jt.params)
    for path in ("pretrain.npz", "pretrain.pt"):
        pt.network.load_state_dict(before)
        load_ssl_encoder_into_trainer(pt, str(tmp_path / path), verbose=False)
        got = pt.network.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), (path, k)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    assert moved and all(k.startswith("conv_blocks_context.") for k in moved)


def test_split_and_ds_factors_match_jax(prepared, tiny_stunet):
    for configuration, arch in (("tiny_stunet", "STUNet-B"), ("tiny_plain", None)):
        jt, pt = _trainers(prepared, configuration, f"split_{configuration}", arch_name=arch)
        assert pt.do_split() == jt.do_split()
        assert pt._ds_factors() == jt._ds_factors()
        assert pt.aug_config.ds_scales == jt.aug_config.ds_scales
        assert pt.initial_patch_size == jt.initial_patch_size
        assert pt.aug_config.spatial.seg_labels == jt.aug_config.spatial.seg_labels
    assert pt._ds_factors() == [(1, 1, 1), (2, 2, 2)]


@pytest.mark.parametrize("preset", ["ATKTrainer", "STUNetTrainer_base_ft"])
def test_lr_at_epoch_boundaries_matches_jax(prepared, tiny_stunet, preset):
    cfg = replace(port_trainer_mod.get_trainer_config(preset), num_epochs=4,
                  num_iterations_per_epoch=3, arch_name=None)
    jt, pt = _trainers(prepared, "tiny_plain", f"lr_{preset}",
                       **{k: v for k, v in asdict(cfg).items()
                          if k not in ("name", "compute_dtype", "num_workers")})
    for step in range(0, 14):
        np.testing.assert_allclose(pt._lr_schedule(step), float(jt._lr_schedule(step)),
                                   rtol=1e-6, err_msg=str(step))
    assert pt._lr_schedule(3) == pt._lr_schedule(5) != pt._lr_schedule(6)


def test_promote_2d_configuration_matches_jax():
    cfg = {"patch_size": [64, 80], "pool_op_kernel_sizes": [[1, 1], [2, 2], [2, 2]],
           "conv_kernel_sizes": [[3, 3]] * 3, "num_pool_per_axis": [2, 2],
           "median_image_size_in_voxels": [120, 140], "batch_size": 12}
    assert (port_trainer_mod.promote_2d_configuration(cfg)
            == jax_trainer_mod.promote_2d_configuration(cfg))


def test_presets_match_jax():
    assert set(port_trainer_mod.TRAINER_PRESETS) == set(jax_trainer_mod.TRAINER_PRESETS)
    for name, cfg in jax_trainer_mod.TRAINER_PRESETS.items():
        jax_fields = asdict(cfg)
        # one device: the port has no mesh to scale the batch to
        assert jax_fields.pop("scale_batch_to_devices") is True, name
        assert asdict(port_trainer_mod.get_trainer_config(name)) == jax_fields, name
    with pytest.raises(RuntimeError, match="Unknown trainer"):
        port_trainer_mod.get_trainer_config("nope")


def test_unported_options_raise(prepared):
    """The two options that raised before their port now run: a cascade
    stage constructs and initialises (three input channels, the previous
    stage's one-hot labels), then raises JAX's RuntimeError where its
    previous stage's predictions are missing; ATKTrainerDA5 initialises with
    the JAX trainer's DA5 settings and takes a step."""
    tmp_path, plans_file, dataset_json = prepared
    setup_env(tmp_path)
    plans = load_json(plans_file)
    plans["configurations"]["cascade"] = {"inherits_from": "tiny_plain",
                                          "previous_stage": "tiny_plain"}
    t = Trainer(plans, "cascade", 0, dataset_json, TrainerConfig(compute_dtype="float32"),
                output_folder=os.path.join(str(tmp_path), "port_cascade",
                                           "T__ATKPlans__cascade"), device="cpu")
    t.initialize()
    assert next(p for p in t.network.parameters() if p.ndim == 5).shape[1] == 3
    assert t.aug_config.cascade_foreground_labels == (1, 2)
    with pytest.raises(RuntimeError, match="T__ATKPlans__tiny_plain.*predicted_next_stage"):
        t.get_dataloaders()
    assert port_trainer_mod.get_trainer_config("ATKTrainerDA5").aggressive_da
    jt, pt = _trainers(prepared, "tiny_plain", "da5", aggressive_da=True)
    assert pt.cfg.aggressive_da and pt.aug_config.spatial.p_rotation == 0.4
    for part in ("spatial", "intensity", "da5"):
        assert asdict(getattr(pt.aug_config, part)) == asdict(getattr(jt.aug_config, part)), part
    data, seg = _batch(3, patch=pt.initial_patch_size)
    loss = pt.train_step(torch.from_numpy(data), torch.from_numpy(seg))
    assert np.isfinite(loss.item()) and pt.step_counter == 1


@pytest.fixture(scope="module")
def trained(prepared):
    """One epoch of the port's run_training with the case cache, then a
    resume for a second epoch through the host pipeline."""
    tmp_path, plans_file, dataset_json = prepared
    setup_env(tmp_path)
    cfg = TrainerConfig(name="PortRun", num_epochs=1, num_iterations_per_epoch=3,
                        num_val_iterations_per_epoch=2, compute_dtype="float32",
                        num_workers=1, save_every=1)
    out = os.path.join(str(tmp_path), "port_run")
    t = Trainer(plans_file, "tiny_plain", 0, dataset_json, cfg, output_folder=out,
                device="cpu")
    t.run_training()
    t2 = Trainer(plans_file, "tiny_plain", 0, dataset_json,
                 replace(cfg, num_epochs=2, device_cache=False), output_folder=out,
                 device="cpu")
    # the resume reads checkpoint_latest: the final checkpoint, renamed
    os.replace(os.path.join(t.output_folder, "checkpoint_final.npz"),
               os.path.join(t.output_folder, "checkpoint_latest.npz"))
    t2.run_training(continue_training=True)
    return t, t2


def test_run_training_writes_checkpoints_and_logs(trained):
    t, t2 = trained
    assert t.device_cache_train is not None and t2.device_cache_train is None
    for f in ("checkpoint_final.npz", "checkpoint_best.npz", "debug.json",
              "training_log.txt", "progress.png"):
        assert os.path.isfile(os.path.join(t.output_folder, f)), f
    assert not os.path.isfile(os.path.join(t.output_folder, "checkpoint_latest.npz"))
    lg = t2.logger.logging
    assert len(lg["train_losses"]) == 2 and all(np.isfinite(lg["train_losses"]))
    assert lg["ema_fg_dice"][-1] is not None
    assert t2.step_counter == 6 and t2.current_epoch == 1
    assert [e["epoch"] for e in t2.epoch_timings] == [1]


def test_resume_restores_the_optimizer(trained, prepared):
    """The resumed trainer starts from the saved weights and SGD momentum:
    the checkpoint holds both, and the JAX checkpoint reader sees the
    weights in its own layout."""
    t, t2 = trained
    from anatomask_tpu.training.checkpoint import load_checkpoint as jax_load
    arrays, meta = jax_load(os.path.join(t2.output_folder, "checkpoint_final.npz"))
    assert meta["current_epoch"] == 2 and meta["step_counter"] == 6
    assert meta["network_arch_name"] is None and meta["configuration_name"] == "tiny_plain"
    sd = state_dict_from_jax("PlainConvUNet", arrays["network_weights"])
    for k, v in t2.network.state_dict().items():
        assert torch.equal(sd[k], v), k
    state = arrays["torch_optimizer_state"]
    assert len(state) == len(list(t2.network.parameters()))
    assert all("momentum_buffer" in s for s in state.values())


def test_checkpoint_writer_writes_each_file(trained):
    """An epoch's latest and best checkpoints come from one snapshot on the
    writer thread: both files hold the same bytes, the weights in the JAX
    layout."""
    _, t2 = trained
    t2._write_checkpoints_async(["w_latest.npz", "w_best.npz"], t2._snapshot_state(),
                                t2._checkpoint_meta())
    t2._join_ckpt_writer()
    a, b = (os.path.join(t2.output_folder, f) for f in ("w_latest.npz", "w_best.npz"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    from anatomask_tpu.training.checkpoint import load_checkpoint as jax_load
    arrays, _ = jax_load(b)
    sd = state_dict_from_jax("PlainConvUNet", arrays["network_weights"])
    for k, v in t2.network.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_perform_actual_validation_matches_jax(trained, prepared):
    """The port's final validation and the JAX one on the same weights. Both
    packages' predictors read the port's checkpoint_final.npz; their logits
    agree to 1e-4 of the largest, and where their argmax differs JAX's top
    two logits are within that too (a rounding tie). Each class's mean Dice
    in summary.json is JAX's within 1e-3 plus what the tie voxels can move:
    2 / (n_ref + n_pred) a voxel of the smallest case of that class, over
    the number of cases."""
    _, t2 = trained
    tmp_path, plans_file, dataset_json = prepared
    setup_env(tmp_path)
    metrics = t2.perform_actual_validation()
    jt = jax_trainer_mod.Trainer(
        plans_file, "tiny_plain", 0, dataset_json,
        jax_trainer_mod.TrainerConfig(name="JaxVal", compute_dtype="float32"),
        output_folder=os.path.join(str(tmp_path), "jax_val"))
    jt.load_checkpoint(os.path.join(t2.output_folder, "checkpoint_final.npz"))
    ref = jt.perform_actual_validation()

    port = Predictor(device="cpu")
    port.initialize_from_trained_model_folder(t2.output_folder_base, use_folds=[0])
    jp = JaxPredictor()
    jp.initialize_from_trained_model_folder(t2.output_folder_base, use_folds=[0])
    _, val_keys = t2.do_split()
    dataset = CaseDataset(t2.preprocessed_dataset_folder, val_keys)
    flips = 0
    for k in val_keys:
        data = np.asarray(dataset.load_case(k)[0])
        got = port.predict_sliding_window_return_logits(data)
        want = np.asarray(jp.predict_sliding_window_return_logits(data))
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-4 * scale, k
        top2 = np.sort(want, 0)[-2:]
        differ = got.argmax(0) != want.argmax(0)
        assert (top2[1] - top2[0])[differ].max(initial=0) <= 1e-4 * scale, k
        flips += int(differ.sum())
    summary = load_json(os.path.join(t2.output_folder, "validation", "summary.json"))
    cases = ref["metric_per_case"]
    for cls in ref["mean"]:
        smallest = min(c["metrics"][cls]["n_ref"] + c["metrics"][cls]["n_pred"] for c in cases)
        tol = 1e-3 + flips * 2 / max(smallest, 1) / len(cases)
        np.testing.assert_allclose(summary["mean"][str(cls)]["Dice"], ref["mean"][cls]["Dice"],
                                   rtol=0, atol=tol, err_msg=str(cls))
        assert np.isfinite(metrics["mean"][cls]["Dice"])

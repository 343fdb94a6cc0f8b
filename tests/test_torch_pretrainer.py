"""The port's PretrainTrainer on the CPU, on a synthetic
dataset written by the JAX package's planner and preprocessor: both methods
run end to end with a tiny encoder, the checkpoint set and history.json are
written, resume continues at the saved epoch, a mismatched architecture
refuses the checkpoint, and the per-step LR, the per-epoch EMA decay and
len_loss follow the JAX package's formulas."""
import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from anatomask_tpu.ssl.anatomask import guided_keep_ratio as jax_keep_ratio
from anatomask_tpu.ssl.ema import ema_decay_schedule as jax_ema_decay
from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_tpu.training.schedules import linear_warmup_cosine_schedule as jax_lr
from anatomask_torch.ssl.pretrain import PretrainConfig, PretrainTrainer
from synthetic import make_synthetic_dataset, setup_env

DATASET = "Dataset905_TPT"
FILES = ("checkpoint_latest.pt", "B_head_latest.pt", "checkpoint_best.pt",
         "checkpoint_final.pt", "history.json")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("torch_pretrain")
    raw, _, _ = setup_env(tmp_path)
    make_synthetic_dataset(raw, DATASET, num_cases=6, shape=(20, 22, 24))
    from anatomask_tpu.planning.fingerprint import DatasetFingerprintExtractor
    from anatomask_tpu.planning.planner import ExperimentPlanner
    from anatomask_tpu.preprocessing.preprocessor import DefaultPreprocessor
    DatasetFingerprintExtractor(DATASET, num_processes=1).run()
    ExperimentPlanner(DATASET).plan_experiment()
    DefaultPreprocessor().run(DATASET, "3d_fullres", "ATKPlans", num_processes=1)
    return tmp_path


def _cfg(method, **kw):
    cfg = PretrainConfig(method=method, patch_size=(16, 16, 16), batch_size=2,
                         num_epochs=2, iters_per_epoch=2, compute_dtype="float32",
                         encoder_dims=(4, 8, 8), num_workers=1, warmup_epochs=1)
    return replace(cfg, **kw)


def _trainer(prepared, cfg, name):
    setup_env(prepared)
    return PretrainTrainer(DATASET, cfg, device="cpu",
                           output_folder=os.path.join(str(prepared), "results", name))


@pytest.fixture(scope="module")
def anatomask_run(prepared):
    torch.manual_seed(0)
    t = _trainer(prepared, _cfg("anatomask"), "anatomask")
    return t, t.run_pretraining()


def test_anatomask_run_writes_checkpoints_and_history(anatomask_run):
    t, history = anatomask_run
    assert len(history["train_loss"]) == 2
    assert all(np.isfinite(history[k]).all() for k in history)
    for f in FILES:
        assert os.path.isfile(os.path.join(t.output_folder, f)), f
    with open(os.path.join(t.output_folder, "history.json")) as f:
        assert json.load(f) == history
    assert [e["epoch"] for e in t.epoch_timings] == [0, 1]
    assert t.device_cache is not None and t.step_counter == 4


def test_each_snapshot_is_written_once(anatomask_run):
    """An epoch's latest, head and (when it is the best) best checkpoints are
    one file under several names, and the final checkpoint is the last
    epoch's (no step after it); its metadata holds the epoch's val_loss."""
    from anatomask_torch.training.checkpoint import load_trainer_checkpoint
    t, history = anatomask_run

    def inode(f):
        return os.stat(os.path.join(t.output_folder, f)).st_ino

    assert inode("checkpoint_latest.pt") == inode("B_head_latest.pt") == inode(
        "checkpoint_final.pt")
    last_is_best = history["val_loss"][-1] < min(history["val_loss"][:-1])
    assert (inode("checkpoint_best.pt") == inode("checkpoint_latest.pt")) == last_is_best
    _, meta = load_trainer_checkpoint(os.path.join(t.output_folder, "checkpoint_final.pt"))
    assert meta["current_epoch"] == 2 and meta["val_loss"] == history["val_loss"][-1]


def test_teacher_lags_the_student(anatomask_run):
    t, _ = anatomask_run
    gaps = [(e - p).abs().max().item()
            for e, p in zip(t.teacher.parameters(), t.model.parameters())]
    assert max(gaps) > 0


def test_lr_follows_the_jax_schedule(anatomask_run):
    """The LR of step n is the warmup-cosine schedule at AdamW's count before
    the update, optax's law; the schedule equals JAX's at every step."""
    t, _ = anatomask_run
    iters, cfg = t.iters_per_epoch, t.cfg
    ref = jax_lr(cfg.lr, warmup_steps=cfg.warmup_epochs * iters,
                 total_steps=cfg.num_epochs * iters, warmup_start_lr=1e-6)
    for step in range(cfg.num_epochs * iters):
        np.testing.assert_allclose(t.lr_schedule(step), float(ref(step)), rtol=1e-6)
    assert t._optimizer_count() == 4
    for group in t.optimizer.param_groups:
        np.testing.assert_allclose(group["lr"], float(ref(3)), rtol=1e-6)


def test_epoch_settings_match_jax(prepared):
    t = _trainer(prepared, _cfg("anatomask", num_epochs=10), "settings")
    jm = jax_build_spark_model(JaxPretrainConfig(
        patch_size=(16, 16, 16), compute_dtype="float32", encoder_dims=(4, 8, 8),
        encoder_depth=(1, 1, 1), decoder_width=8))
    assert (t.model.fmap, t.model.len_keep) == (tuple(jm.fmap), jm.len_keep)
    L = int(np.prod(jm.fmap))
    for epoch in range(10):
        decay, keep, len_loss = t.epoch_settings(epoch)
        np.testing.assert_allclose(decay, jax_ema_decay(epoch, 10, 0.999, 0.9999), rtol=1e-12)
        assert keep == jax_keep_ratio(epoch, 10, True)
        assert len_loss == int((L - jm.len_keep) * jax_keep_ratio(epoch, 10, True))


def test_resume_continues_at_epoch_2(prepared, anatomask_run):
    t, _ = anatomask_run
    t2 = PretrainTrainer(DATASET, replace(t.cfg, num_epochs=3, device_cache=False),
                         device="cpu", output_folder=t.output_folder)
    history = t2.run_pretraining(continue_training=True)
    assert t2.current_epoch == 2 and len(history["train_loss"]) == 1
    assert t2._optimizer_count() == 6  # 4 restored steps + 2
    with open(os.path.join(t.output_folder, "pretrain_log.txt")) as f:
        assert "resumed at epoch 2" in f.read()


def test_config_mismatch_on_load_raises(prepared, anatomask_run):
    t, _ = anatomask_run
    t2 = _trainer(prepared, replace(t.cfg, patch_size=(16, 16, 32)), "mismatch")
    t2.get_dataloaders()
    t2.initialize()
    with pytest.raises(AttributeError, match="config mismatch"):
        t2.load_checkpoint(os.path.join(t.output_folder, "checkpoint_latest.pt"))


def test_snapshot_is_a_copy(anatomask_run):
    """The checkpoint writer thread gets host copies: later in-place updates
    of the weights and the optimizer do not reach them."""
    t, _ = anatomask_run
    snap = t._snapshot_state()
    name, p = next(iter(t.model.state_dict().items()))
    before = snap["network_weights"][name].clone()
    with torch.no_grad():
        p.add_(1.0)
    try:
        torch.testing.assert_close(snap["network_weights"][name], before, rtol=0, atol=0)
    finally:
        with torch.no_grad():
            p.sub_(1.0)


def _started(prepared, cfg, name):
    t = _trainer(prepared, cfg, name)
    t.get_dataloaders()
    t.initialize()
    return t


def test_an_iteration_is_next_batch_then_train_step(prepared):
    """run_pretraining's iteration is `next_batch` then `train_step`: a
    trainer driven through them alone reaches the weights that
    run_pretraining reaches over one epoch (validation moves no weight), and
    counts its wait for the batches."""
    cfg = _cfg("anatomask", num_epochs=1)
    run = _trainer(prepared, cfg, "iteration_run")
    run.run_pretraining()
    t = _started(prepared, cfg, "iteration_steps")
    decay, _, len_loss = t.epoch_settings(0)
    try:
        for _ in range(t.iters_per_epoch):
            t.train_step(t.next_batch(), len_loss, decay)
    finally:
        t.stop_data()
    assert t.step_counter == run.step_counter == t.iters_per_epoch and t.fetch_wait_s > 0
    for (name, p), q in zip(run.model.named_parameters(), t.model.parameters()):
        assert torch.equal(p, q), name


def test_next_batch_opens_the_data_span_beside_the_step(prepared):
    from torch.profiler import ProfilerActivity, profile
    t = _started(prepared, _cfg("anatomask"), "data_span")
    decay, _, len_loss = t.epoch_settings(0)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t.train_step(t.next_batch(), len_loss, decay)
    finally:
        t.stop_data()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name in ("pretrain.data", "pretrain.step"))
    assert [n for _, _, n in spans] == ["pretrain.data", "pretrain.step"]
    assert spans[0][1] <= spans[1][0]


def test_spark_run(prepared):
    t = _trainer(prepared, _cfg("spark", device_cache=False), "spark")
    history = t.run_pretraining()
    assert all(np.isfinite(history[k]).all() for k in history)
    assert t.teacher is t.model and t.device_cache is None
    for f in FILES:
        assert os.path.isfile(os.path.join(t.output_folder, f)), f


@pytest.fixture(scope="module")
def lamb_run(prepared):
    """One epoch at encoder depth 2 with two microbatches a step, LAMB, and
    densify norm "bn" (SparseBatchNorm), then a second trainer to resume."""
    cfg = _cfg("anatomask", num_epochs=1, encoder_depth=(2, 2, 2), grad_accum_steps=2,
               optimizer="lamb", densify_norm="bn")
    torch.manual_seed(1)
    t = _trainer(prepared, cfg, "lamb")
    history = t.run_pretraining()
    t2 = _trainer(prepared, replace(cfg, num_epochs=2), "lamb")
    t2.get_dataloaders()
    t2.initialize()
    return t, history, t2


def test_lamb_accumulation_run(lamb_run):
    """Every step in two microbatches through LAMB; the checkpoint meta names
    the model size and the optimizer, as the JAX trainer's does."""
    from anatomask_torch.ssl.pretrain import Lamb
    from anatomask_torch.training.checkpoint import load_trainer_checkpoint
    t, history, _ = lamb_run
    assert all(np.isfinite(history[k]).all() for k in history)
    assert isinstance(t.optimizer, Lamb) and t.grad_accum_steps == 2
    assert t._optimizer_count() == 2
    assert [len(s) for s in t.model.sparse_encoder.sp_cnn.conv_blocks_context] == [2, 2, 2]
    _, meta = load_trainer_checkpoint(os.path.join(t.output_folder, "checkpoint_latest.pt"))
    assert meta["model_size"] == "B" and meta["method"] == "anatomask"
    assert meta["pretrain_config"]["optimizer"] == "lamb"
    assert meta["pretrain_config"]["grad_accum_steps"] == 2
    assert meta["spark_config"]["densify_norm_str"] == "bn"


def test_resume_restores_lamb_state(lamb_run):
    """The student (the densify BatchNorms' affine leaves among them), the
    teacher and LAMB's moments and step counts come back bit for bit."""
    t, _, t2 = lamb_run
    latest = os.path.join(t.output_folder, "checkpoint_latest.pt")
    t2.load_checkpoint(latest)
    from anatomask_torch.training.checkpoint import load_trainer_checkpoint
    state, _ = load_trainer_checkpoint(latest)
    for mine, theirs in ((t2.model, t.model), (t2.teacher, t.teacher)):
        want = theirs.state_dict()
        assert mine.state_dict().keys() == want.keys()
        for k, v in mine.state_dict().items():
            torch.testing.assert_close(v, want[k], rtol=0, atol=0)
    assert any(k.startswith("densify_norms.") for k in state["network_weights"])
    saved, now = state["optimizer_state"]["state"], t2.optimizer.state_dict()["state"]
    assert saved.keys() == now.keys() and t2._optimizer_count() == 2
    for i in saved:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(now[i][k], saved[i][k], rtol=0, atol=0)
    history = t2.run_pretraining(continue_training=True)
    assert len(history["train_loss"]) == 1 and t2._optimizer_count() == 4


def test_output_folder_names_model_size(prepared):
    setup_env(prepared)
    t = PretrainTrainer(DATASET, _cfg("spark", model_size="L"), device="cpu")
    assert os.path.basename(t.output_folder) == "pretrain_spark_L"
    assert [len(s) for s in t.model.sparse_encoder.sp_cnn.conv_blocks_context] == [2, 2, 2]


def test_config_fields_match_jax():
    """PretrainConfig has JAX's fields with JAX's defaults, except
    scale_batch_to_devices, which one device has no use for (TrainerConfig
    drops it too)."""
    from dataclasses import asdict
    jax_fields = asdict(JaxPretrainConfig())
    assert jax_fields.pop("scale_batch_to_devices") is True
    assert asdict(PretrainConfig()) == jax_fields

"""The float32 path of anatomask_torch (`-compute_dtype float32`) on the CPU:

- the variant rule sends fp32 convs with C and F multiples of 32 (16-byte
  aligned x) to the tf32x3 variant of csrc/conv3x3_igemm.cuh, the fp32 stems
  to the stem variant (csrc/conv3x3_stem.cuh, on the FP32 pipe) and the
  other shapes to the simple variant; BN is one the C launcher builds;
- the weight's TF32 hi and lo planes (pack_weight "tf32x3"): hi is a TF32
  value (its low 13 bits zero), |lo| <= 2^-11 |w|, and hi + lo is w to within
  lo's own rounding (half a TF32 ulp of lo);
- a CPU tensor takes the plain version: no count moves, tf32x3's included;
- building the PretrainTrainer, the Trainer and the Predictor at float32,
  and the pretrain and predict entries up to their first real work at
  `-compute_dtype float32`, turn TF32 off for cuDNN and cuBLAS (PyTorch's
  default computes a float32 convolution in TF32);
- a tiny float32 SparK step against the JAX package's on the same weights,
  data and mask.

The kernel itself runs only on the card: chip_smoke.py holds it to the plain
version at every fp32 launch shape of the paths, and
tests/torch_zslab_roundoff.py (mode `fp32`) to a float64 reference."""
import json
import re
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_tpu.ssl.spark import spark_loss as jax_spark_loss
from anatomask_torch import cli, convert
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.ops import _build
from anatomask_torch.ops.conv3x3 import (STEM_MAX_C, TF32_TILES, VARIANTS, conv3d_3x3,
                                         conv_variant, pack_weight, tf32_split, tf32_tile)
from anatomask_torch.ops.zslab_conv import conv3d_zconcat, conv3d_zslab
from anatomask_torch.ssl import pretrain as tp
from anatomask_torch.ssl.spark import random_keep_mask
from anatomask_torch.training.trainer import Trainer, TrainerConfig

from torch_parity import numpy_params, to_ncdhw

# (dtype, C, F, 16-byte-aligned x) -> variant
RULE_CASES = (
    [((torch.float32, C, F, True), "tf32x3") for C, F in ((32, 32), (32, 64), (64, 32),
                                                           (96, 160), (512, 512), (1024, 512))]
    + [((torch.float32, C, F, True), "simple") for C, F in ((48, 64), (64, 48), (32, 16))]
    + [((torch.float32, 8, 32, True), "stem")]
    + [((torch.float32, 32, 32, False), "simple"), ((torch.bfloat16, 32, 32, True), "hopper"),
       ((torch.bfloat16, 1, 32, True), "stem")])


@pytest.mark.parametrize("case,variant", RULE_CASES,
                         ids=[f"{str(c[0])[6:]}-C{c[1]}-F{c[2]}-{'al' if c[3] else 'unal'}"
                              for c, _ in RULE_CASES])
def test_fp32_variant_rule(case, variant):
    assert conv_variant(*case) == variant
    assert variant in VARIANTS


def test_fp32_stems_stay_simple():
    """Every fp32 stem the rule could see (C up to STEM_MAX_C, F a multiple
    of 16 up to 96) no longer stays on the simple variant: it takes the stem
    variant, as in bf16, aligned or not."""
    for C in range(1, STEM_MAX_C + 1):
        for F in range(16, 97, 16):
            for aligned in (True, False):
                assert conv_variant(torch.float32, C, F, aligned) == "stem", (C, F, aligned)


def test_tf32_tile_is_one_the_launcher_builds():
    """tf32_tile picks, for every F multiple of 32, a BN of
    CONV3X3_TF32X3_TILES that divides F: 64 where it can, else 32."""
    header = (_build.CSRC / "conv3x3_igemm.cuh").read_text()
    body = header[header.index("#define CONV3X3_TF32X3_TILES"):].split("\n\n")[0]
    built = {int(b) for b in re.findall(r"TILE\((\d+)\)", body)}
    assert built == set(TF32_TILES)
    for F in range(32, 2049, 32):
        bn = tf32_tile(F)
        assert bn in built and F % bn == 0 and bn == max(b for b in built if F % b == 0)


@pytest.mark.parametrize("C,F,scale", [(32, 64, 1.0), (96, 32, 1e-3), (64, 160, 3e4)])
def test_pack_weight_tf32_planes(C, F, scale):
    rs = np.random.RandomState(C + F)
    w = torch.from_numpy((scale * rs.standard_normal((3, 3, 3, C, F))).astype(np.float32))
    packed = pack_weight(w, "tf32x3")
    assert packed.shape == (2, F, 27 * C) and packed.dtype == torch.float32
    assert packed.is_contiguous()
    w2 = w.reshape(27 * C, F).t()
    hi, lo = packed[0], packed[1]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert bool((lo.abs() <= 2.0 ** -11 * w2.abs()).all())
    # lo is w - hi (exact in fp32) rounded to TF32: off by at most half its ulp
    _, e = torch.frexp(lo)
    half_ulp = torch.ldexp(torch.ones_like(lo), e - 12)
    assert bool(((w2 - hi - lo).abs() <= half_ulp).all())
    # hi is w rounded to the nearest TF32 value
    _, e = torch.frexp(w2)
    assert bool(((w2 - hi).abs() <= torch.ldexp(torch.ones_like(w2), e - 12)).all())
    assert torch.equal(torch.stack(tf32_split(w2)), packed)


def test_tf32_split_rounds_ties_away_from_zero():
    """cvt.rna.tf32.f32's rounding: to nearest, ties away from zero."""
    one_ulp = 2.0 ** -10
    v = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4, 1 + 3 * one_ulp / 4,
                      0.0, -0.0])
    hi, lo = tf32_split(v)
    assert hi.tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 0.0, -0.0]
    assert torch.equal(hi + lo, v)


@pytest.mark.parametrize("kernel", ["conv3d_3x3", "conv3d_zconcat", "conv3d_zslab"])
def test_plain_path_counts_no_tf32x3_launch(kernel):
    """fp32 at a tf32x3 shape on the CPU runs the plain version, forward and
    dx: neither the total nor any variant's count moves."""
    f = {"conv3d_3x3": conv3d_3x3, "conv3d_zconcat": conv3d_zconcat,
         "conv3d_zslab": conv3d_zslab}[kernel]
    counted = conv3d_zslab if kernel == "conv3d_zslab" else conv3d_3x3
    x = torch.rand(1, 4, 5, 6, 32).requires_grad_(True)
    w = torch.rand(3, 3, 3, 32, 64)
    assert conv_variant(x.dtype, 32, 64, x.data_ptr() % 16 == 0) == "tf32x3"
    before = [(fn_.launches, dict(fn_.launches_by_variant)) for fn_ in (counted, conv3d_zslab,
                                                                       conv3d_3x3)]
    f(x, w).sum().backward()
    assert [(fn_.launches, dict(fn_.launches_by_variant)) for fn_ in (counted, conv3d_zslab,
                                                                     conv3d_3x3)] == before


@pytest.fixture
def tf32_defaults():
    """PyTorch's default flags (cuDNN in TF32, cuBLAS not) before the test,
    the process's own after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _tf32_off():
    return not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def _write_pretrain_dataset(root, monkeypatch):
    """A preprocessed dataset folder as far as the trainer's constructor
    reads it: the plans and dataset.json."""
    name = "Dataset961_Fp32"
    base = root / "preprocessed" / name
    base.mkdir(parents=True)
    (base / "dataset.json").write_text(json.dumps(
        {"channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1},
         "numTraining": 2, "file_ending": ".nii.gz"}))
    (base / "ATKPlans.json").write_text(json.dumps(
        {"dataset_name": name, "plans_name": "ATKPlans", "configurations": {"3d_fullres": {
            "data_identifier": "ATKPlans_3d_fullres", "patch_size": [32, 32, 32],
            "spacing": [1.0, 1.0, 1.0]}}}))
    for which in ("preprocessed", "results"):
        monkeypatch.setenv(f"ATK_{which}", str(root / which))
    return name


SMALL = dict(patch_size=(32, 32, 32), encoder_dims=(4, 8, 16), num_workers=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pretrain_trainer_sets_tf32(dtype, tf32_defaults, tmp_path, monkeypatch):
    name = _write_pretrain_dataset(tmp_path, monkeypatch)
    tp.PretrainTrainer(name, tp.PretrainConfig(compute_dtype=dtype, **SMALL), device="cpu")
    # float32 turns TF32 off; bfloat16 leaves PyTorch's flags as they were
    assert _tf32_off() == (dtype == "float32")


def test_trainer_turns_tf32_off(tf32_defaults, tmp_path):
    plans = {"dataset_name": "Dataset962_Fp32", "plans_name": "P", "configurations": {
        "3d_fullres": {"data_identifier": "P_3d_fullres", "patch_size": [16, 16, 16],
                       "UNet_class_name": "PlainConvUNet", "spacing": [1.0] * 3}}}
    t = Trainer(plans, "3d_fullres", 0, {"labels": {"background": 0, "a": 1},
                                         "channel_names": {"0": "CT"}},
                TrainerConfig(compute_dtype="float32"), output_folder=str(tmp_path / "out"),
                preprocessed_dataset_folder_base=str(tmp_path / "pp"), device="cpu")
    assert t.dtype == torch.float32 and _tf32_off()


def test_predictor_turns_tf32_off(tf32_defaults):
    Predictor(dtype=torch.bfloat16, device="cpu")
    assert torch.backends.cudnn.allow_tf32
    p = Predictor(dtype=torch.float32, device="cpu")
    assert p.dtype == torch.float32 and _tf32_off()


class _SetUp(Exception):
    """Raised where an entry's setup ends and its real work would begin."""


def test_pretrain_entry_turns_tf32_off(tf32_defaults, tmp_path, monkeypatch):
    _write_pretrain_dataset(tmp_path, monkeypatch)
    seen = []

    def stop(self, continue_training=False):
        seen.append((self.dtype, _tf32_off()))
        raise _SetUp

    monkeypatch.setattr(tp.PretrainTrainer, "run_pretraining", stop)
    with pytest.raises(_SetUp):
        cli.pretrain_entry(["961", "-model", "S", "-patch_size", "32", "32", "32",
                            "-batch_size", "2", "-compute_dtype", "float32", "-device", "cpu"])
    assert seen == [(torch.float32, True)]


def test_predict_entry_turns_tf32_off(tf32_defaults, tmp_path, monkeypatch):
    seen = []

    def stop(self, *args, **kwargs):
        seen.append((self.dtype, _tf32_off()))
        raise _SetUp

    monkeypatch.setattr(Predictor, "initialize_from_trained_model_folder", stop)
    monkeypatch.setenv("ATK_results", str(tmp_path))
    with pytest.raises(_SetUp):
        cli.predict_entry(["-i", str(tmp_path), "-o", str(tmp_path / "out"),
                           "-d", "Dataset963_Fp32", "-c", "3d_fullres", "-compute_dtype",
                           "float32", "-device", "cpu"])
    assert seen == [(torch.float32, True)]


# The SparK step below: torch pinned to THREADS intra-op threads (its CPU sums
# split by thread count); dims 4-16 at 32^3 (an 8x8x8 patch grid at the
# bottom, 205 visible voxels a sample).
THREADS = 4
CFG = dict(encoder_dims=(4, 8, 16), patch_size=(32, 32, 32), compute_dtype="float32")
# max|g - r| over a leaf against its largest entry, with the cancelled conv
# biases (zero in exact arithmetic, round-off in both) held to 1e-6 of the
# step's largest gradient, as tests/test_torch_step.py holds them. Measured
# here: 5.87e-6 at the worst leaf (the loss equal); the limit leaves room for
# the summation order of XLA's CPU convolutions, which follows its thread pool
_GRAD_RTOL = 1e-4
_CANCELLED = re.compile(r"sparse_encoder\.sp_cnn\.conv_blocks_context\.\d+\.\d+\.conv[12]\.bias")


def test_fp32_spark_step_matches_jax():
    """One float32 SparK step of the port (spark_train_step, lr 0: the
    gradients only) against the JAX package's SparK loss and its clipped
    gradients (jitted) under the same mask: the loss within rtol 1e-5, each
    gradient leaf within _GRAD_RTOL of its largest entry."""
    jmodel = jax_build_spark_model(JaxPretrainConfig(**CFG))
    params = numpy_params(jmodel, 31, jnp.zeros((1, 32, 32, 32, 1)),
                          jmodel.mask(jax.random.PRNGKey(0), 1))
    x = np.random.RandomState(32).rand(2, 32, 32, 32, 1).astype(np.float32)
    noise = torch.from_numpy(np.random.RandomState(33).rand(2, int(np.prod(jmodel.fmap)))
                             .astype(np.float32))
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        model = tp.build_spark_model(tp.PretrainConfig(**CFG), device="cpu")
        model.load_state_dict(convert.from_jax("spark", params))
        optimizer = tp.make_optimizer(model, replace(tp.PretrainConfig(), lr=0.0))
        loss = tp.spark_train_step(model, optimizer, to_ncdhw(x), noise=noise, lr=0.0).item()
    finally:
        torch.set_num_threads(saved)
    keep = random_keep_mask(2, model.fmap, model.len_keep, noise=noise)
    mask = jnp.asarray(keep[:, 0, ..., None].numpy())

    @jax.jit
    def loss_and_grads(p):
        def loss_fn(q):
            inp, rec = jmodel.apply({"params": q}, jnp.asarray(x), mask)
            return jax_spark_loss(inp, rec, mask)[0]

        value, g = jax.value_and_grad(loss_fn)(p)
        return value, optax.clip_by_global_norm(12.0).update(g, optax.EmptyState())[0]

    ref_loss, ref_grads = loss_and_grads(params)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    want = {k: v.numpy() for k, v in convert.from_jax(
        "spark", jax.tree_util.tree_map(np.asarray, ref_grads)).items()}
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    g_max = max(np.abs(r).max() for r in want.values())
    for name, r in want.items():
        g = named[name].grad.numpy()
        if _CANCELLED.fullmatch(name):
            assert max(np.abs(g).max(), np.abs(r).max()) <= 1e-6 * g_max, name
        else:
            assert np.abs(g - r).max() <= _GRAD_RTOL * np.abs(r).max(), name

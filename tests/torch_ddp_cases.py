"""The cases of tests/test_torch_ddp.py and tests/test_torch_multinode.py,
run by each rank of a process group and by one process on the global batch:
torch only (the ranks import or run this module, not the test files, so they
never import JAX).

Every input is the global batch's, made with numpy from a seed; a rank takes
its rows (`mesh.local_rows`), so that both runs see the same global batch
and the same draws. The global batch is sized for `ranks` ranks (2 unless
given): 2 rows a rank for the AnatoMask step (one a microbatch), 1 for the
supervised cases.

As a script, a process that torchrun started runs every case as its rank of
the launcher's group (parallel/mesh.py `run_joined`):

    torchrun --nnodes 2 --nproc_per_node 2 --node_rank K --master_addr 127.0.0.1 \
        --master_port PORT tests/torch_ddp_cases.py <folder> <ranks> <tag>
"""
import contextlib
import os
import sys
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as fn

from anatomask_torch.models import layers
from anatomask_torch.parallel import mesh
from anatomask_torch.ssl import sparse
from anatomask_torch.ssl.pretrain import (PretrainConfig, anatomask_train_step, build_spark_model,
                                          make_optimizer, make_teacher)
from anatomask_torch.ssl.spark import spark_loss
from anatomask_torch.training.losses import dc_and_ce_loss, dc_and_topk_loss
from anatomask_torch.training.trainer import Trainer, get_trainer_config

THREADS = 2
SPARK = dict(patch_size=(32, 32, 32), encoder_dims=(4, 8, 16), compute_dtype="float32",
             densify_norm="bn", decoder_norm="bn", norm_batch_pooled=True)
ACCUM, STEPS, LEN_LOSS, LR = 2, 2, 20, 1e-3
RANKS = 2
IGNORE = 3
PATCH = (16, 16, 16)


def global_batch(ranks=RANKS):
    """The AnatoMask step's global batch: ACCUM microbatches of a row a rank."""
    return ACCUM * ranks


def sup_batch_size(ranks=RANKS):
    return ranks
PRESETS = ("ATKTrainerBN", "ATKTrainerTopkLoss")
LOSSES = {"dc_topk": lambda o, t: dc_and_topk_loss(o, t, ignore_label=IGNORE, k_percent=60.0),
          "dc_ce": lambda o, t: dc_and_ce_loss(o, t, ignore_label=IGNORE)}


def spark_inputs(fmap, len_keep, ranks=RANKS):
    """The global batch (B, 1, *patch), the steps' uniforms (STEPS, 2, B, L)
    and one keep mask (B, 1, *fmap)."""
    rs = np.random.RandomState(21)
    B = global_batch(ranks)
    x = rs.rand(B, 1, *SPARK["patch_size"]).astype(np.float32)
    L = int(np.prod(fmap))
    noise = rs.rand(STEPS, 2, B, L).astype(np.float32)
    keep = np.zeros((B, L), bool)
    for b in range(B):
        keep[b, rs.permutation(L)[:len_keep]] = True
    return x, noise, keep.reshape(B, 1, *fmap)


def _rows(a, rows):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if rows is None else t[rows]


def _conv3x3_64(x, w, padding=1):
    """conv3d_3x3's function (x (B, X, Y, Z, C), w (3, 3, 3, C, F)) by
    F.conv3d, in x's dtype."""
    y = fn.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), padding=padding)
    return y.permute(0, 2, 3, 4, 1)


def _row_moments_64(x, mask=None, square_in_dtype=False):
    """row_moments' sums in x's dtype."""
    m = 1.0 if mask is None else mask.unsqueeze(-1).to(x.dtype)
    return (x * m).sum((1, 2, 3)), (x * x * m).sum((1, 2, 3))


@contextlib.contextmanager
def _float64_ops():
    """The model's 3x3x3 convs and norm sums in float64 (their fp32/bf16-only
    ops swapped for library versions of the same functions), so that a
    float64 SparK runs the port's model, norms, collectives, loss and
    optimizer with round-off near 1e-16."""
    saved = (layers.conv3d_3x3, layers.conv3d_zconcat, layers.row_moments, sparse.row_moments)
    layers.conv3d_3x3 = layers.conv3d_zconcat = _conv3x3_64
    layers.row_moments = sparse.row_moments = _row_moments_64
    try:
        yield
    finally:
        layers.conv3d_3x3, layers.conv3d_zconcat, layers.row_moments, sparse.row_moments = saved


def anatomask_case(init_state, ranks=RANKS, float64=False):
    """The pooled SparK's loss under one mask (the JAX comparison), then
    STEPS AnatoMask steps in ACCUM microbatches: losses, gradients after the
    last step, student and teacher. `float64`: the model, its input and its
    steps in float64 (`_float64_ops`), a witness that what separates ranks
    from one process is float32 round-off."""
    cfg = PretrainConfig(**SPARK)
    student = build_spark_model(cfg, device="cpu")
    x, noise, keep = spark_inputs(student.fmap, student.len_keep, ranks)
    ops = contextlib.nullcontext()
    if float64:
        student.double()
        for m in student.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        x, ops = x.astype(np.float64), _float64_ops()
    student.load_state_dict(init_state)
    rows = mesh.local_rows(global_batch(ranks), ACCUM)
    xr = _rows(x, rows).contiguous(memory_format=torch.channels_last_3d)
    with ops:
        with torch.no_grad():
            masked_loss = spark_loss(*student(xr, _rows(keep, rows)), _rows(keep, rows))[0]
        teacher = make_teacher(student)
        optimizer = make_optimizer(student, cfg)
        losses = []
        for step in range(STEPS):
            loss, _, _ = anatomask_train_step(student, teacher, optimizer, xr, LEN_LOSS,
                                              noise=torch.from_numpy(noise[step]), lr=LR,
                                              grad_accum_steps=ACCUM)
            losses.append(float(loss))
    return dict(masked_loss=float(masked_loss), losses=losses,
                grads={n: p.grad.clone() for n, p in student.named_parameters()},
                student=student.state_dict(), teacher=teacher.state_dict())


def sup_plans(ranks=RANKS):
    """A two-stage PlainConvUNet at 4-8 features, patch 16^3, a row a rank,
    batch Dice, one channel."""
    return {
        "dataset_name": "Dataset999_DDP", "plans_name": "ATKPlans",
        "original_median_spacing_after_transp": [1.0, 1.0, 1.0],
        "original_median_shape_after_transp": [20, 20, 20], "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": 0.0, "std": 1.0, "percentile_00_5": -3.0, "percentile_99_5": 3.0}},
        "configurations": {"3d_fullres": {
            "data_identifier": "ATKPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": sup_batch_size(ranks), "patch_size": list(PATCH),
            "median_image_size_in_voxels": [20, 20, 20], "spacing": [1.0, 1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
            "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
            "unet_max_num_features": 8, "n_conv_per_stage_encoder": [1, 1],
            "n_conv_per_stage_decoder": [1], "num_pool_per_axis": [1, 1, 1],
            "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2]], "conv_kernel_sizes": [[3, 3, 3]] * 2,
            "batch_dice": True}}}


DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2, "ignore": IGNORE},
                "channel_names": {"0": "CT"}, "numTraining": 4, "file_ending": ".nii.gz"}


def sup_batch(spatial, seed, ranks=RANKS):
    """(data (B, *spatial, 1) fp32, seg (B, *spatial, 1) int16 with the ignore
    label and the sampler's -1 pad) of the global batch."""
    rs = np.random.RandomState(seed)
    B = sup_batch_size(ranks)
    data = rs.standard_normal((B, *spatial, 1)).astype(np.float32)
    seg = rs.randint(0, IGNORE + 1, (B, *spatial, 1)).astype(np.int16)
    seg[:, :2] = -1
    return data, seg


def trainer_case(preset, folder, ranks=RANKS):
    """Two train_steps and a val_step of `preset` (fp32) on the global
    batch's rows: losses, the val step's counts, gradients, weights."""
    cfg = replace(get_trainer_config(preset), compute_dtype="float32", num_workers=1)
    trainer = Trainer(sup_plans(ranks), "3d_fullres", 0, DATASET_JSON, cfg, output_folder=folder,
                      preprocessed_dataset_folder_base=folder, device="cpu")
    trainer.initialize()
    rows = mesh.local_rows(sup_batch_size(ranks))
    losses = []
    for step in range(2):
        data, seg = sup_batch(trainer.initial_patch_size, step, ranks)
        losses.append(float(trainer.train_step(_rows(data, rows), _rows(seg, rows))))
    data, seg = sup_batch(PATCH, 7, ranks)
    val = [t.detach().clone() for t in trainer.val_step(_rows(data, rows), _rows(seg, rows))]
    return dict(losses=losses, val=val,
                grads={n: p.grad.clone() for n, p in trainer.network.named_parameters()},
                weights=trainer.network.state_dict())


def loss_inputs(seed, ranks=RANKS):
    """Global logits (B, *PATCH, 3) and labels with the ignore label."""
    rs = np.random.RandomState(seed)
    B = sup_batch_size(ranks)
    logits = rs.standard_normal((B, *PATCH, 3)).astype(np.float32)
    target = rs.randint(0, IGNORE + 1, (B, *PATCH)).astype(np.int64)
    target[:, :6] = IGNORE  # ignored voxels: zeros that tie at the top-k threshold
    return logits, target


def loss_case(name, ranks=RANKS):
    """A compound loss on the rank's rows: its share and the gradient of the
    rank's share with respect to its logits."""
    logits, target = loss_inputs(5, ranks)
    rows = mesh.local_rows(sup_batch_size(ranks))
    lg = _rows(logits, rows).requires_grad_(True)
    loss = LOSSES[name](lg, _rows(target, rows))
    loss.backward()
    return dict(loss=float(loss.detach()), grad=lg.grad.clone())


def run_all(folder, ranks=RANKS, tag="", float64=False):
    """Every case on the global batch of `ranks` ranks (`float64`: the
    AnatoMask case in float64 too, as "anatomask64"); the results into
    <folder>/<tag>rank<r>.pt (without a group: <tag>one.pt)."""
    torch.set_num_threads(THREADS)
    torch.manual_seed(0)
    init = torch.load(os.path.join(folder, "spark_init.pt"))
    out = {"anatomask": anatomask_case(init, ranks),
           **{p: trainer_case(p, os.path.join(folder, f"{tag}{p}_{mesh.world()}"), ranks)
              for p in PRESETS},
           **{f"loss_{n}": loss_case(n, ranks) for n in LOSSES}}
    if float64:
        out["anatomask64"] = anatomask_case(init, ranks, float64=True)
    name = "one.pt" if not mesh.distributed() else f"rank{mesh.rank()}.pt"
    torch.save(out, os.path.join(folder, tag + name))


if __name__ == "__main__":
    mesh.run_joined(run_all, "cpu", sys.argv[1], int(sys.argv[2]), sys.argv[3])

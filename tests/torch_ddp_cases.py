"""The cases of tests/test_torch_ddp.py, run by each rank of a process group
and by one process on the global batch: torch only (the spawned ranks import
this module, not the test file, so they never import JAX).

Every input is the global batch's, made with numpy from a seed; a rank takes
its rows (`mesh.local_rows`), so that both runs see the same global batch
and the same draws."""
import os
from dataclasses import replace

import numpy as np
import torch

from anatomask_torch.parallel import mesh
from anatomask_torch.ssl.pretrain import (PretrainConfig, anatomask_train_step, build_spark_model,
                                          make_optimizer, make_teacher)
from anatomask_torch.ssl.spark import spark_loss
from anatomask_torch.training.losses import dc_and_ce_loss, dc_and_topk_loss
from anatomask_torch.training.trainer import Trainer, get_trainer_config

THREADS = 2
SPARK = dict(patch_size=(32, 32, 32), encoder_dims=(4, 8, 16), compute_dtype="float32",
             densify_norm="bn", decoder_norm="bn", norm_batch_pooled=True)
GLOBAL_BATCH, ACCUM, STEPS, LEN_LOSS, LR = 4, 2, 2, 20, 1e-3
IGNORE = 3
PATCH = (16, 16, 16)
SUP_BATCH = 2
PRESETS = ("ATKTrainerBN", "ATKTrainerTopkLoss")
LOSSES = {"dc_topk": lambda o, t: dc_and_topk_loss(o, t, ignore_label=IGNORE, k_percent=60.0),
          "dc_ce": lambda o, t: dc_and_ce_loss(o, t, ignore_label=IGNORE)}


def spark_inputs(fmap, len_keep):
    """The global batch (B, 1, *patch), the steps' uniforms (STEPS, 2, B, L)
    and one keep mask (B, 1, *fmap)."""
    rs = np.random.RandomState(21)
    x = rs.rand(GLOBAL_BATCH, 1, *SPARK["patch_size"]).astype(np.float32)
    L = int(np.prod(fmap))
    noise = rs.rand(STEPS, 2, GLOBAL_BATCH, L).astype(np.float32)
    keep = np.zeros((GLOBAL_BATCH, L), bool)
    for b in range(GLOBAL_BATCH):
        keep[b, rs.permutation(L)[:len_keep]] = True
    return x, noise, keep.reshape(GLOBAL_BATCH, 1, *fmap)


def _rows(a, rows):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if rows is None else t[rows]


def anatomask_case(init_state):
    """The pooled SparK's loss under one mask (the JAX comparison), then
    STEPS AnatoMask steps in ACCUM microbatches: losses, gradients after the
    last step, student and teacher."""
    cfg = PretrainConfig(**SPARK)
    student = build_spark_model(cfg, device="cpu")
    student.load_state_dict(init_state)
    x, noise, keep = spark_inputs(student.fmap, student.len_keep)
    rows = mesh.local_rows(GLOBAL_BATCH, ACCUM)
    xr = _rows(x, rows).contiguous(memory_format=torch.channels_last_3d)
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


def sup_plans():
    """A two-stage PlainConvUNet at 4-8 features, patch 16^3, batch 2, batch
    Dice, one channel."""
    return {
        "dataset_name": "Dataset999_DDP", "plans_name": "ATKPlans",
        "original_median_spacing_after_transp": [1.0, 1.0, 1.0],
        "original_median_shape_after_transp": [20, 20, 20], "image_reader_writer": "NiftiIO",
        "transpose_forward": [0, 1, 2], "transpose_backward": [0, 1, 2],
        "foreground_intensity_properties_per_channel": {"0": {
            "mean": 0.0, "std": 1.0, "percentile_00_5": -3.0, "percentile_99_5": 3.0}},
        "configurations": {"3d_fullres": {
            "data_identifier": "ATKPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": SUP_BATCH, "patch_size": list(PATCH),
            "median_image_size_in_voxels": [20, 20, 20], "spacing": [1.0, 1.0, 1.0],
            "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
            "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
            "unet_max_num_features": 8, "n_conv_per_stage_encoder": [1, 1],
            "n_conv_per_stage_decoder": [1], "num_pool_per_axis": [1, 1, 1],
            "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2]], "conv_kernel_sizes": [[3, 3, 3]] * 2,
            "batch_dice": True}}}


DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2, "ignore": IGNORE},
                "channel_names": {"0": "CT"}, "numTraining": 4, "file_ending": ".nii.gz"}


def sup_batch(spatial, seed):
    """(data (B, *spatial, 1) fp32, seg (B, *spatial, 1) int16 with the ignore
    label and the sampler's -1 pad) of the global batch."""
    rs = np.random.RandomState(seed)
    data = rs.standard_normal((SUP_BATCH, *spatial, 1)).astype(np.float32)
    seg = rs.randint(0, IGNORE + 1, (SUP_BATCH, *spatial, 1)).astype(np.int16)
    seg[:, :2] = -1
    return data, seg


def trainer_case(preset, folder):
    """Two train_steps and a val_step of `preset` (fp32) on the global
    batch's rows: losses, the val step's counts, gradients, weights."""
    cfg = replace(get_trainer_config(preset), compute_dtype="float32", num_workers=1)
    trainer = Trainer(sup_plans(), "3d_fullres", 0, DATASET_JSON, cfg, output_folder=folder,
                      preprocessed_dataset_folder_base=folder, device="cpu")
    trainer.initialize()
    rows = mesh.local_rows(SUP_BATCH)
    losses = []
    for step in range(2):
        data, seg = sup_batch(trainer.initial_patch_size, seed=step)
        losses.append(float(trainer.train_step(_rows(data, rows), _rows(seg, rows))))
    data, seg = sup_batch(PATCH, seed=7)
    val = [t.detach().clone() for t in trainer.val_step(_rows(data, rows), _rows(seg, rows))]
    return dict(losses=losses, val=val,
                grads={n: p.grad.clone() for n, p in trainer.network.named_parameters()},
                weights=trainer.network.state_dict())


def loss_inputs(seed):
    """Global logits (B, *PATCH, 3) and labels with the ignore label."""
    rs = np.random.RandomState(seed)
    logits = rs.standard_normal((SUP_BATCH, *PATCH, 3)).astype(np.float32)
    target = rs.randint(0, IGNORE + 1, (SUP_BATCH, *PATCH)).astype(np.int64)
    target[:, :6] = IGNORE  # ignored voxels: zeros that tie at the top-k threshold
    return logits, target


def loss_case(name):
    """A compound loss on the rank's rows: its share and the gradient of the
    rank's share with respect to its logits."""
    logits, target = loss_inputs(5)
    rows = mesh.local_rows(SUP_BATCH)
    lg = _rows(logits, rows).requires_grad_(True)
    loss = LOSSES[name](lg, _rows(target, rows))
    loss.backward()
    return dict(loss=float(loss.detach()), grad=lg.grad.clone())


def run_all(folder):
    """Every case; the results into <folder>/rank<r>.pt (world 1: one.pt)."""
    torch.set_num_threads(THREADS)
    torch.manual_seed(0)
    out = {"anatomask": anatomask_case(torch.load(os.path.join(folder, "spark_init.pt"))),
           **{p: trainer_case(p, os.path.join(folder, f"{p}_{mesh.world()}")) for p in PRESETS},
           **{f"loss_{n}": loss_case(n) for n in LOSSES}}
    name = "one.pt" if not mesh.distributed() else f"rank{mesh.rank()}.pt"
    torch.save(out, os.path.join(folder, name))

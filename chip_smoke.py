#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (anatomask_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which raises on a failed check:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/conv3x3.cu, csrc/moments.cu and csrc/zslab_conv.cu
   (the two convs share the kernels of csrc/conv3x3_igemm.cuh: its hopper
   and simple variants) for sm_90a from the checkout's sources, one nvcc
   each, all at once; print each kernel's registers and spills from ptxas's
   report, and check with cuobjdump's SASS that every hopper instantiation
   of both conv libraries holds HGMMA (wgmma) instructions;
3. conv kernel (TPU kernel #1): at every call site of the stride-1 3x3x3
   conv on the main paths (the paths run it for the forwards below
   MIN_VOLUME output voxels and for every dx; the table checks all), the
   kernel against its plain PyTorch version on the card. For the
   pretraining step: forward and dx (bf16 at B = 1 through the autograd
   Function and at the step's B = 4, relative max error <= 1e-2; fp32
   without TF32 on a few shapes, <= 1e-5), and at B = 4 its time beside the
   bound, the plain version's time and F.conv3d's (a yardstick only; the port
   never calls it for this conv). For inference: forward at the tile
   forward's B = 8 (the 8 mirror flips), <= 1e-2, and the same times. Then
   bf16 shapes off the paths at the hopper variant's edges (ragged M, F = 96
   and 160 with BN = 32, C = 96 and 160 with BK = 32), fwd + dx, <= 1e-2;
   then kernel #2 at every shape where the paths run it (the per-tap
   forwards, >= MIN_VOLUME output voxels; models/layers.py ConvND): forward
   and dx through conv3d_zconcat (dx is kernel #1, rounded once) at the
   step's B = 4, forward at inference's B = 8, against the plain versions,
   rel. max error <= 1e-2, bit-equal on >= 95% of the elements, kernel #1's
   forward at least 10 points lower; its time beside kernel #1's;
4. moments kernel: at every instance-norm shape of both paths (the step's
   masked and plain norms at B = 4, inference's at B = 8), bf16 and fp32,
   with and without square_in_dtype (x*x rounded to bf16 first, as the
   paths run it), the kernel against its plain version, |diff| / sum|x| <=
   1e-5 per (sample, channel), and a second call bit-equal to the first; in
   bf16 the call's time (CUDA events around back-to-back calls: host and
   device) and the kernel's device time (torch.profiler) beside the bound,
   the plain version's time and one torch.var_mean call's (a yardstick
   only), with GB/s, and that a call allocates its output alone (the scratch
   is kept); then the same checks on four shapes off the main paths that
   take the kernel's other code paths;
5. zslab kernel (TPU kernel #2), at the shapes of probes/probe_pallas_v4.py
   (dec3: C = F = 64, enc0: C = F = 32, 112x112x128, B = 4, bf16): forward
   and dx through the autograd Function against the plain version (rel. max
   error <= 1e-2, and bit-equal on >= 95% of the elements, where kernel #1's
   one rounding must match on at least 10 points fewer, so that a kernel
   that drops the per-tap rounding fails), and three fp32 shapes off the
   probe's without TF32 (H % 8 != 0, C = 1, C != F; <= 1e-5). At both probe shapes: forward and
   forward + dx times, TFLOP/s and the bound, the plain version's time,
   F.conv3d's (a yardstick only), kernel #1's at the same shape, and
   max|kernel #2 - kernel #1| / max|kernel #1| in bf16. The probe's timed
   calls are this kernel's path: its count is set to 0 just before them,
   and every one of its launches must run the hopper variant;
6. references: a tiny SparK (also with densify norm "bn", with "ln", in
   the batch-pooled mode with decoder norm "bn", and with the MedNeXt
   encoder), the three ablation decoders and SparseConvNeXtBlock, and a tiny
   STUNet, PlainConvUNet (instance and batch norm) and ResidualEncoderUNet
   through both sliding-window paths, in fp32 on the card against the same
   models on the CPU, rel. error <= 1e-4; then remat: one backward of a tiny
   SparK and a tiny STUNet at depth 2, fp32 and bf16, twice without remat
   and once with it, the gradients bit-equal and every kernel launched
   again in the remat backward, the fp32 gradients within 1e-4 of the
   largest against the CPU's;
7. pretraining step: the AnatoMask pretraining step at full STUNet-B width (patch
   112x112x128, batch 4, mask ratio 0.6, bf16, decoder width 512) for 5
   steps, checking finite losses, the hard masks, the launches by kernel and
   variant (kernel #1 34 hopper, kernel #2 14 hopper and the stem's 2
   simple, 44 moments; `path_launches` counts them from the site tables) and
   the EMA law, and timing the last 3 steps;
8. inference: bench_inference.py's configuration at full width through the
   Predictor: STUNet-B (6 stages, 1 input channel, 3 classes), a
   240x240x155 volume, patch 128^3, step 0.5, 18 tiles, 8-flip mirror TTA,
   tile batch 1, bf16; 3 volumes, the first a warm-up, checking finite
   logits of shape (3, 240, 240, 155) and, a tile, 7 kernel #1 (hopper), 10
   kernel #2 (9 hopper, the stem simple) and 22 moments launches;
9. pretraining loop (PretrainTrainer): a synthetic preprocessed dataset
   (8 cases of 1 x 160^3) written with the port's own code into a temporary
   folder, then PretrainTrainer.run_pretraining at full STUNet-B width (patch
   112x112x128 from a 189x179x196 initial patch, batch 4, bf16, AnatoMask)
   for 2 epochs x 5 iterations with the GPU case cache holding every
   training case, a resume from checkpoint_latest for 1 epoch x 2 iterations
   through the host pipeline, and a second resume for 1 epoch x 6 iterations
   with a case cache too small for the training set, so that staged slots
   are copied in on a side stream and applied in place between steps;
   checking the launches of every training step (as the bare step's) and
   validation step (one forward), finite losses, the checkpoint
   files, the resumed epochs,
   that at least one slot was refilled and that every slot then holds its
   case bit for bit, and printing seconds an epoch, fetch-wait, validation and
   checkpoint seconds, patches/s and the step time beside the bare step's;
10. prediction from raw files (Predictor.predict_from_files): a trained-model
   folder written with the port's own code in the JAX package's layout
   (plans.json of nnU-Net's 3d_fullres PlainConvUNet as the JAX planner
   writes it: 4 channels, 4 labels, masked z-score, 1 mm, patch 128^3, 6
   stages of 32-320 features, 2 convs a stage; dataset.json; a seeded
   fold_0/checkpoint_final.npz) and three BraTS-sized raw cases (4 x
   240x240x155 int16 .nii.gz, nonzero inside an ellipsoid; two at 1 mm, one
   at 1 x 1 x 1.5 mm), predicted with 2 spawned preprocessing workers, bf16,
   8-flip TTA, tile batch 1, the first case a warm-up; checking each
   output's shape, spacing, affine and labels, the launches by kernel and
   variant (a tile: 7 kernel #1, 10 kernel #2 of which the C = 4 stem simple,
   22 moments), and predict_single_npy_array against the resampled case's
   file; printing seconds a case split into fetch-wait, sliding window and
   export, tiles a case, peak memory, and that case's host split in-process;
11. supervised training (Trainer, STUNetTrainer_base_ft: STUNet-B, patch
   128^3 from a 205^3 initial patch, batch 2, bf16, 5 deep-supervision
   heads, AdamW + cosine, the default augmentation with per-label seg warps)
   on 6 synthetic 1 x 160^3 cases with labels {0, 1, 2} written with the
   port's own code: load_ssl_encoder_into_trainer from phase 9's
   checkpoint_final.pt (every encoder tensor the pretrained one's, the rest
   untouched), run_training for 2 epochs x 5 iterations + 2 validation
   iterations through the GPU case cache, a resume for one epoch through the
   host pipeline, perform_actual_validation (summary.json with a finite
   Dice per class), checkpoint_final.npz through the Predictor against the
   trainer's network (<= 1e-3), the bare step (median of steps 3-5, with a
   torch.profiler split of 3 more by kernel group) and a validation step,
   then 3 bare ATKTrainer steps of phase 10's PlainConvUNet (SGD); checking
   the launches of every run (a training step 23 kernel #1, 9 + 1 kernel
   #2, 22 moments; a validation step 7, 9 + 1, 22) and printing seconds an
   epoch split, each training step between synchronizations, peak memory.
   Its new launch shapes (the steps at B = 2, the final validation's
   forwards at B = 16 = tile batch 2 x 8 flips) are held against the plain
   versions, with the gates above, before the main paths run;
12. pretrain-H: AnatoMask pretraining as `atk_pretrain -model H` runs it
   by default (STUNet-H SparK: dims 96-1536, 3 blocks a stage, LightDecoder
   width 1536; patch 112x112x128, batch 4 in 2 microbatches, mask ratio 0.6,
   bf16, AdamW, remat on every encoder stage and decoder block). Its launch
   shapes are held against the plain versions among the kernel phases (the
   step's at the microbatch B = 2, timed, with each kernel's step total
   beside its bound and F.conv3d's or torch.var_mean's; the validation
   forwards and a grad_accum_steps=1 step at B = 4, among them 192 -> 192 at
   112x112x128, a 1.23e9-element activation; the finetuning step's at B = 2,
   timed), with the gates above. Then 5 bare steps (2 warm-up), checking
   finite losses, the hard masks and the launches by kernel and variant
   (per microbatch the teacher's forward, the student's, remat's second
   forward of every stage and decoder block, and dx), a torch.profiler
   split, a step at grad_accum_steps=1 and a LAMB step; then
   PretrainTrainer.run_pretraining at H for 1 epoch x 2 iterations with the
   case cache, validation and checkpoints (an epoch's one ~12.8 GB file
   under all its names, written into a temporary folder after a check that
   the disk holds three, its GB and seconds printed), a resumed epoch; then
   load_ssl_encoder_into_trainer
   from its checkpoint_final.pt into STUNetTrainer_huge (remat) and 2 bare
   supervised steps at 128^3, batch 2; step ms and peak memory of each;
13. the command line (anatomask_torch/cli.py), entry by entry with the argv
   a user types, from a raw dataset to ensembled, postprocessed
   segmentations, in a temporary ATK_raw/ATK_preprocessed/ATK_results tree
   deleted at its end: a KiTS-like CT dataset (CLI_TRAIN, CLI_TEST: int16
   HU, labels background/kidney/tumour, two cases resampled) written with
   the port's NIfTI writer and generate_dataset_json; plan_and_preprocess
   (--verify_dataset_integrity, 4 spawned workers), whose plans must be the
   JAX planner's (3d_fullres PlainConvUNet 32-320, 6 stages, patch 128^3,
   batch 2; 2d 192^2, batch 64; no 3d_lowres); then the launch shapes those
   plans imply held against the plain versions with the gates above (the
   PlainConvUNet step at B = 2 and its tile forward at B = 16, timed; the
   pretraining microbatch B = 2); pretrain (atk_pretrain's defaults at
   STUNet-B, 1 epoch x 3 iterations); train ATKTrainer_1epoch folds 0 and 1
   --npz and STUNetTrainer_base_ft from the pretraining checkpoint (10
   iterations, 2 validation iterations); predict the test cases with both
   (launches by kernel and variant checked per forward); ensemble;
   evaluate; find_best_configuration; apply_postprocessing;
   accumulate_crossval_results; export_model and install_model into a
   second results tree, whose fold 0 must predict logits equal to the
   original's; move_plans_between_datasets. Every output is read back;
   pretrain, both trains and predict must each launch all three kernels.
   Printed: each entry's seconds, peak memory and launches, the steps'
   median ms, seconds a test case and fold;
14. the out-of-memory ladder: one volume at tile batch 2 under a
   torch.cuda.set_per_process_memory_fraction cap between the uncapped tile
   batch 1 and 2 peaks: the device-resident path must run out at 2, finish
   at 1, and match the uncapped tile batch 1 logits within 1e-3 relative.

A kernel's time is the median of three runs of back-to-back calls, each
run timed with CUDA events, after a warm-up call. Each main path (7-13)
runs with the launch counts set to 0 just before it and read just after
(13: each entry), and every launch it makes must be at a shape that phases
3 and 4 (and 11's, 12's and 13's gates) held against the plain version
(kernel #2's: its path shapes in phase 3); phase 14 runs after that check,
as its tile batch 2 launches at B = 16 on the 4-channel PlainConvUNet.
Between phases, free_memory collects reference
cycles and empties the allocator's cache, so that each phase's memory
peaks count its own tensors; after phase 11 it prints what stayed allocated
before and after the collection. The last three
lines of standard output are the nvidia-smi line, one JSON object {"kernels": [...]}, and
{"ok": true, "device": {...}}.
"""
import copy
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as fn

from anatomask_torch import cli
from anatomask_torch.convert import plain_unet_state_dict_from_jax, state_dict_to_jax
from anatomask_torch.data.dataset import CaseDataset
from anatomask_torch.dataset_conversion.generate_dataset_json import generate_dataset_json
from anatomask_torch.imageio.nifti import NiftiIO, read_nifti, write_nifti
from anatomask_torch.inference import predictor as pred_mod
from anatomask_torch.inference.export import (
    convert_predicted_logits_to_segmentation_with_correct_shape)
from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.inference.sliding_window import (compute_steps_for_sliding_window,
                                                      is_oom_error, make_tile_predictor,
                                                      sliding_window_predict,
                                                      sliding_window_predict_device_resident)
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.models.layers import MIN_VOLUME
from anatomask_torch.models.plain_unet import PlainConvUNet, ResidualEncoderUNet
from anatomask_torch.models.stunet import STUNet
from anatomask_torch.ops import _build
from anatomask_torch.ops import conv3x3 as conv_mod
from anatomask_torch.ops import moments as moments_mod
from anatomask_torch.ops import zslab_conv as zslab_mod
from anatomask_torch.ops.conv3x3 import (HOPPER_TILES, conv3d_3x3, conv3d_3x3_forward,
                                         conv3d_3x3_plain, flip_weight, igemm_variant,
                                         zero_launch_counts)
from anatomask_torch.ops.moments import row_moments, row_moments_forward, row_moments_plain
from anatomask_torch.ops.zslab_conv import (conv3d_zconcat, conv3d_zslab, conv3d_zslab_forward,
                                            conv3d_zslab_plain)
from anatomask_torch.plans.plans_handler import PlansManager, load_json, save_json
from anatomask_torch.preprocessing.preprocessor import save_properties
from anatomask_torch.ssl.pretrain import (Lamb, PretrainConfig, PretrainTrainer,
                                          accumulation_steps, anatomask_train_step,
                                          build_spark_model, load_ssl_encoder_into_trainer,
                                          make_optimizer, make_teacher)
from anatomask_torch.ssl import pretrain as pretrain_mod
from anatomask_torch.ssl.decoder import DSDecoder, SMiMDecoder, SMiMTwoDecoder
from anatomask_torch.ssl.sparse import SparseConvNeXtBlock, mask_to_resolution, upsample_mask
from anatomask_torch.ssl.spark import random_keep_mask, spark_loss
from anatomask_torch.training import checkpoint as ckpt_mod
from anatomask_torch.training import trainer as trainer_mod
from anatomask_torch.training.checkpoint import load_trainer_checkpoint, save_checkpoint
from anatomask_torch.training.trainer import Trainer, get_trainer_config

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 rate outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
BATCH = 4                 # the pretraining step's batch
TTA_BATCH = 8             # inference: the 8 mirror flips of one tile
# (call site, C, F, (X, Y, Z)) of every stride-1 3x3x3 conv in one forward of
# the pretraining step: 6 in the encoder, 3 densify projections, 8 in the decoder
SITES = [
    ("enc0.conv1", 1, 32, (112, 112, 128)),
    ("enc0.conv2", 32, 32, (112, 112, 128)),
    ("enc1.conv2", 64, 64, (56, 56, 64)),
    ("enc2.conv2", 128, 128, (28, 28, 32)),
    ("enc3.conv2", 256, 256, (14, 14, 16)),
    ("enc4.conv2", 512, 512, (7, 7, 8)),
    ("densify1", 256, 256, (14, 14, 16)),
    ("densify2", 128, 128, (28, 28, 32)),
    ("densify3", 64, 64, (56, 56, 64)),
    ("dec0.conv0", 512, 512, (14, 14, 16)),
    ("dec0.conv1", 512, 256, (14, 14, 16)),
    ("dec1.conv0", 256, 256, (28, 28, 32)),
    ("dec1.conv1", 256, 128, (28, 28, 32)),
    ("dec2.conv0", 128, 128, (56, 56, 64)),
    ("dec2.conv1", 128, 64, (56, 56, 64)),
    ("dec3.conv0", 64, 64, (112, 112, 128)),
    ("dec3.conv1", 64, 32, (112, 112, 128)),
]
# the same for one tile forward of STUNet-B at patch 128^3: 7 in the encoder,
# 10 in the decoder (conv1 reads the concat of the upsampled path and the skip)
INFER_SITES = [
    ("enc0.conv1", 1, 32, (128, 128, 128)),
    ("enc0.conv2", 32, 32, (128, 128, 128)),
    ("enc1.conv2", 64, 64, (64, 64, 64)),
    ("enc2.conv2", 128, 128, (32, 32, 32)),
    ("enc3.conv2", 256, 256, (16, 16, 16)),
    ("enc4.conv2", 512, 512, (8, 8, 8)),
    ("enc5.conv2", 512, 512, (4, 4, 4)),
    ("dec0.conv1", 1024, 512, (8, 8, 8)),
    ("dec0.conv2", 512, 512, (8, 8, 8)),
    ("dec1.conv1", 512, 256, (16, 16, 16)),
    ("dec1.conv2", 256, 256, (16, 16, 16)),
    ("dec2.conv1", 256, 128, (32, 32, 32)),
    ("dec2.conv2", 128, 128, (32, 32, 32)),
    ("dec3.conv1", 128, 64, (64, 64, 64)),
    ("dec3.conv2", 64, 64, (64, 64, 64)),
    ("dec4.conv1", 64, 32, (128, 128, 128)),
    ("dec4.conv2", 32, 32, (128, 128, 128)),
]
# nnU-Net's 3d_fullres PlainConvUNet as the JAX planner writes it (base 32
# features, at most 320, 6 stages, 2 convs a stage in the encoder and the
# decoder) for a BraTS-sized input: 4 channels, 4 labels, patch 128^3
PLAIN_FEATURES, PLAIN_RES = (32, 64, 128, 256, 320, 320), (128, 64, 32, 16, 8, 4)
PLAIN_IN, PLAIN_CLASSES = 4, 4
# the stride-1 3x3x3 convs of one tile forward of it: the C = 4 stem and each
# encoder stage's second conv (its first has stride 2 from stage 1 on), and
# both convs of each decoder stage (conv0 reads the concat of the transposed
# conv's output and the skip)
def plain_sites(n_in):
    return ([("enc0.conv0", n_in, PLAIN_FEATURES[0], (PLAIN_RES[0],) * 3)]
            + [(f"enc{s}.conv1", f, f, (r,) * 3)
               for s, (f, r) in enumerate(zip(PLAIN_FEATURES, PLAIN_RES))]
            + [(f"dec{d}.conv{i}", 2 * f if i == 0 else f, f, (r,) * 3)
               for d, (f, r) in enumerate(zip(PLAIN_FEATURES[-2::-1], PLAIN_RES[-2::-1]))
               for i in (0, 1)])


PLAIN_INFER_SITES = plain_sites(PLAIN_IN)
# (call site, (X, Y, Z), C, masked) of every instance norm in one forward of
# the pretraining step: 10 masked in the encoder, 4 masked densify norms (the
# finest feature's is never read), 8 plain in the LightDecoder
PRETRAIN_NORMS = (
    [(f"enc{d}.norm{i}", vol, c, True)
     for d, (vol, c) in enumerate([((112, 112, 128), 32), ((56, 56, 64), 64),
                                   ((28, 28, 32), 128), ((14, 14, 16), 256),
                                   ((7, 7, 8), 512)]) for i in (1, 2)]
    + [(f"densify{i}", vol, c, True)
       for i, (vol, c) in enumerate([((7, 7, 8), 512), ((14, 14, 16), 256),
                                     ((28, 28, 32), 128), ((56, 56, 64), 64)])]
    + [(f"dec{i}.norm{j}", vol, c, False)
       for i, (vol, cin) in enumerate([((14, 14, 16), 512), ((28, 28, 32), 256),
                                       ((56, 56, 64), 128), ((112, 112, 128), 64)])
       for j, c in ((0, cin), (1, cin // 2))])
# the same for one tile forward of STUNet-B at 128^3: 2 norms a block, 6
# encoder and 5 decoder blocks, all plain
INFER_NORMS = [(f"{part}{d}.norm{i}", (r, r, r), c, False)
               for part, levels in (("enc", [(128, 32), (64, 64), (32, 128), (16, 256),
                                             (8, 512), (4, 512)]),
                                    ("dec", [(8, 512), (16, 256), (32, 128), (64, 64),
                                             (128, 32)]))
               for d, (r, c) in enumerate(levels) for i in (1, 2)]
# the same for the PlainConvUNet tile: one after every conv, 12 in the encoder
# and 10 in the decoder
PLAIN_INFER_NORMS = (
    [(f"enc{s}.norm{i}", (r,) * 3, f, False)
     for s, (f, r) in enumerate(zip(PLAIN_FEATURES, PLAIN_RES)) for i in (0, 1)]
    + [(f"dec{d}.norm{i}", (r,) * 3, f, False)
       for d, (f, r) in enumerate(zip(PLAIN_FEATURES[-2::-1], PLAIN_RES[-2::-1])) for i in (0, 1)])
# probes/probe_pallas_v4.py's shapes for TPU kernel #2 (B = 4, bf16, C = F)
PROBE_SHAPES = (("dec3", 64, (112, 112, 128)), ("enc0", 32, (112, 112, 128)))
# bf16 (C, F, (X, Y, Z)) off the paths at the hopper variant's edges, each with
# a voxel count that is no multiple of 128: F = 96 (BN = 32; its dx has C = 96,
# BK = 32), F = 160 (BN = 32; its dx has C = 160), C = 96
CONV_EDGE_SHAPES = ((64, 96, (9, 10, 11)), (32, 160, (7, 9, 13)), (96, 64, (5, 6, 7)))
# fp32 shapes off the probe's: H % 8 != 0; C = 1; C != F with F over one N tile
ZSLAB_FP32_SHAPES = (((2, 12, 13, 17, 32), 32), ((2, 16, 16, 16, 1), 32),
                     ((1, 10, 12, 14, 48), 80))
# the PretrainTrainer phase: its synthetic dataset and run length
TRAINER_DATASET, TRAINER_CASES, TRAINER_CASE_SHAPE = "Dataset950_ChipSmoke", 8, (160, 160, 160)
TRAINER_EPOCHS, TRAINER_ITERS = 2, 5
# the refill run: 3 slots of 349x339x356 bf16 (80 MiB each) for 5 training cases
REFILL_CACHE_MB, REFILL_ITERS = 256, 6
# the supervised phase: STUNetTrainer_base_ft on 6 synthetic cases of 1 x
# 160^3 with labels {0, 1, 2}, 2 epochs x 5 iterations + 2 validation
# iterations, then a resume for one epoch; 3 bare ATKTrainer steps after it
SUP_DATASET, SUP_CASES, SUP_CASE_SHAPE = "Dataset952_ChipSmokeSup", 6, (160, 160, 160)
SUP_EPOCHS, SUP_ITERS, SUP_VAL_ITERS, PLAIN_STEPS = 2, 5, 2, 3
# the cli phase: a KiTS-like raw dataset (one CT channel; background,
# kidney, tumour) that the port's command line plans, pretrains on, trains,
# predicts, ensembles and postprocesses. Case (name, array shape (z, y, x),
# spacing in mm): 6 training cases at the target spacing, 2 coarser ones
# that preprocessing resamples, 2 test cases with labels
CLI_ID = 953
CLI_DATASET, CLI_TARGET = f"Dataset{CLI_ID}_ChipSmokeCli", "Dataset954_ChipSmokeCliTarget"
CLI_LABELS = {"background": 0, "kidney": 1, "tumor": 2}
CLI_TRAIN = ([(f"case_{i:03d}", (160, 192, 192), (1.5, 0.8, 0.8)) for i in range(6)]
             + [(f"case_{i:03d}", (120, 144, 144), (2.0, 1.0, 1.0)) for i in (6, 7)])
CLI_TEST = [(f"test_{i:03d}", (160, 192, 192), (1.5, 0.8, 0.8)) for i in range(2)]
# what the JAX planner plans for it: nnU-Net's 3d_fullres PlainConvUNet
# (PLAIN_FEATURES, PLAIN_RES) for one channel, patch 128^3, batch 2; 2d
# at patch 192^2, batch 64; no 3d_lowres
CLI_3D = {"UNet_class_name": "PlainConvUNet", "patch_size": [128, 128, 128], "batch_size": 2,
          "UNet_base_num_features": 32, "unet_max_num_features": 320,
          "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 5,
          "conv_kernel_sizes": [[3, 3, 3]] * 6, "n_conv_per_stage_encoder": [2] * 6,
          "n_conv_per_stage_decoder": [2] * 5, "normalization_schemes": ["CTNormalization"]}
CLI_2D = {"patch_size": [192, 192], "batch_size": 64}
CLI_ITERS, CLI_VAL_ITERS, CLI_PRETRAIN_ITERS = 10, 2, 3
CLI_TILE_BATCH = 2 * TTA_BATCH  # the Predictor's tile batch 2 x 8 flips
STEPS, WARMUP = 5, 2
FMAP, LEN_KEEP = (7, 7, 8), 157  # the step's patch grid and visible patches
# bench_inference.py's configuration
VOLUME, NUM_CLASSES, PATCH = (240, 240, 155), 3, (128, 128, 128)
TILES, VOLUMES = 18, 3
# the file path: BraTS-sized raw cases, disk (x, y, z), and their spacings in
# mm; the first a warm-up, the last at 1.5 mm along z so that its data and its
# logits are resampled; the nonzero ellipsoid's semi-axes in mm
FILES_DATASET, RAW_SHAPE = "Dataset137_BraTSLike", (240, 240, 155)
RAW_CASES = (("BraTS_000", (1.0, 1.0, 1.0)), ("BraTS_001", (1.0, 1.0, 1.0)),
             ("BraTS_002", (1.0, 1.0, 1.5)))
BRAIN_MM = (80.0, 95.0, 70.0)


def free_memory():
    """Collect reference cycles, then return the allocator's cached blocks.
    A trainer can sit in a cycle with its device tensors until a collection
    runs (a module's first import from inside it keeps the importing frames,
    and with them the trainer, in one), and torch.cuda.empty_cache() frees
    only blocks that no tensor holds."""
    gc.collect()
    torch.cuda.empty_cache()


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_label(mangled):
    """A readable name for a kernel of csrc/conv3x3_igemm.cuh, else the symbol."""
    m = re.search(r"conv3x3_wgmmaILi(\d+)ELi(\d+)ELb([01])E", mangled)
    if m:
        return f"hopper BK={m[1]} BN={m[2]}{' per-tap' if m[3] == '1' else ''}"
    m = re.search(r"conv3x3_kernelI(f|13__nv_bfloat16)Lb([01])E", mangled)
    if m:
        return f"simple {'fp32' if m[1] == 'f' else 'bf16'}{' per-tap' if m[2] == '1' else ''}"
    return mangled


def build_report(name):
    """Each kernel's registers and spills, and any warning, from ptxas's report
    kept beside csrc/<name>.cu's library."""
    entry = spills = None
    for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            entry = kernel_label(m[1])
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = f"{m[1]} bytes spill stores, {m[2]} loads"
        elif m := re.search(r"Used (\d+) registers", line):
            print(f"[build] {name} {entry}: {m[1]} registers, {spills}")
        elif "warning" in line:
            print(f"[build] {name}: {line.strip()}")


def check_hgmma(name):
    """Every hopper instantiation of csrc/<name>.cu holds HGMMA instructions in
    its SASS (cuobjdump, beside nvcc): a build that lost wgmma fails."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {}
    for chunk in sass.split("Function : ")[1:]:
        label = kernel_label(chunk.split(None, 1)[0])
        if label.startswith("hopper"):
            counts[label] = sum("HGMMA" in line for line in chunk.splitlines())
    check(len(counts) == len(HOPPER_TILES) and all(counts.values()),
          f"{name}: HGMMA instructions by hopper kernel {counts}")
    print(f"[build] {name}: HGMMA instructions in each of its {len(counts)} hopper kernels: "
          f"{', '.join(f'{k} {v}' for k, v in sorted(counts.items()))}")


def zero_counts():
    """Every kernel wrapper's launch counts to 0."""
    zero_launch_counts(conv3d_3x3)
    zero_launch_counts(conv3d_zslab)
    row_moments.launches = 0


COUNT_KEYS = ("conv3x3.hopper", "conv3x3.simple", "zslab.hopper", "zslab.simple", "moments")


def counts():
    """Launches so far: each conv kernel's by variant, and the moments kernel's."""
    return {**{f"conv3x3.{v}": n for v, n in conv3d_3x3.launches_by_variant.items()},
            **{f"zslab.{v}": n for v, n in conv3d_zslab.launches_by_variant.items()},
            "moments": row_moments.launches}


def since(before):
    now = counts()
    return {k: now[k] - before[k] for k in COUNT_KEYS}


def per_tap(vol):
    """The main path rounds this 3x3x3 conv per tap: its forward runs kernel #2
    (models/layers.py ConvND), its dx kernel #1."""
    return math.prod(vol) >= MIN_VOLUME


def path_launches(sites, norms, forwards, backward, stem=True):
    """The launches of `forwards` forwards over `sites` and `norms` and, with
    `backward`, one backward (dx at every site but the stem, sites[0] where
    `stem`, whose input carries no gradient; the norms' backward is
    elementwise)."""
    want = dict.fromkeys(COUNT_KEYS, 0)
    for i, (name, C, F, vol) in enumerate(sites):
        variant = "hopper" if C % 32 == 0 and F % 32 == 0 else "simple"
        want[f"{'zslab' if per_tap(vol) else 'conv3x3'}.{variant}"] += forwards
        if backward and (i > 0 or not stem):
            want[f"conv3x3.{variant}"] += 1
    want["moments"] = forwards * len(norms)
    return want


# a pretraining step (two forwards and the student's backward), a validation
# step and a tile forward
STEP_LAUNCHES = path_launches(SITES, PRETRAIN_NORMS, 2, True)
VAL_LAUNCHES = path_launches(SITES, PRETRAIN_NORMS, 1, False)
TILE_LAUNCHES = path_launches(INFER_SITES, INFER_NORMS, 1, False)
PLAIN_TILE_LAUNCHES = path_launches(PLAIN_INFER_SITES, PLAIN_INFER_NORMS, 1, False)
# the supervised paths: a STUNet-B finetuning step (one forward, dx everywhere
# but the stem) and validation step at B = 2 over the tile's site tables (the
# same network at the same 128^3 patch), the final validation's forwards at
# B = 16 (tile batch 2 x 8 mirror flips), and an ATKTrainer step of the
# PlainConvUNet at B = 2
SUP_BATCH, VAL_TTA_BATCH = 2, 16
SUP_STEP_LAUNCHES = path_launches(INFER_SITES, INFER_NORMS, 1, True)
SUP_VAL_LAUNCHES = path_launches(INFER_SITES, INFER_NORMS, 1, False)
PLAIN_STEP_LAUNCHES = path_launches(PLAIN_INFER_SITES, PLAIN_INFER_NORMS, 1, True)

# pretrain-H: `atk_pretrain -model H` as it runs by default (STUNet-H SparK:
# dims 96-1536, 3 blocks a stage, LightDecoder width 1536; patch 112x112x128,
# batch 4 in 2 microbatches of 2, mask ratio 0.6, bf16, AdamW, remat on every
# encoder stage and decoder block), then its encoder in STUNetTrainer_huge
# (dims 96-1536, 6 stages of 3 blocks, remat) at patch 128^3, batch 2
H_CFG = PretrainConfig(model_size="H", grad_accum_steps=2)
H_MICRO = BATCH // H_CFG.grad_accum_steps  # the microbatch
H_DIMS = (96, 192, 384, 768, 1536)
H_RES = ((112, 112, 128), (56, 56, 64), (28, 28, 32), (14, 14, 16), (7, 7, 8))
H_DEC = tuple(zip((1536, 768, 384, 192), H_RES[3::-1]))  # (C in, resolution) a block
# stride-1 3x3x3 convs of one forward: the stem and 5 a stage in the encoder
# (block 0's conv1 strides from stage 1 on) and 8 in the decoder, all under
# remat; the 3 densify projections (the coarsest is an identity), outside it
H_REMAT_SITES = (
    [("enc0.0.conv1", 1, 96, H_RES[0])]
    + [(f"enc{d}.{b}.conv{i}", c, c, vol) for d, (c, vol) in enumerate(zip(H_DIMS, H_RES))
       for b in range(3) for i in (1, 2) if (b, i) != (0, 1)]
    + [(f"dec{i}.conv{j}", c, c // (1 + j), vol) for i, (c, vol) in enumerate(H_DEC)
       for j in (0, 1)])
H_DENSIFY_SITES = [(f"densify{i}", H_DIMS[-1 - i], H_DIMS[-1 - i], H_RES[-1 - i])
                   for i in (1, 2, 3)]
# the norms: 6 masked a stage, 4 masked densify norms (the finest feature's
# is never read) and 8 plain in the decoder
H_REMAT_NORMS = (
    [(f"enc{d}.{b}.norm{i}", vol, c, True) for d, (c, vol) in enumerate(zip(H_DIMS, H_RES))
     for b in range(3) for i in (1, 2)]
    + [(f"dec{i}.norm{j}", vol, c // (1 + j), False) for i, (c, vol) in enumerate(H_DEC)
       for j in (0, 1)])
H_DENSIFY_NORMS = [(f"densify{i}", H_RES[-1 - i], H_DIMS[-1 - i], True) for i in range(4)]
H_SITES, H_NORMS = H_REMAT_SITES + H_DENSIFY_SITES, H_REMAT_NORMS + H_DENSIFY_NORMS


def h_forwards(name, micro):
    """Forwards of a site or norm in one H step: a microbatch's teacher and
    student forwards and, under remat, the student's second forward."""
    return micro * (2 if name.startswith("densify") else 3)


def h_step_launches(micro):
    """One H step in `micro` microbatches: the forwards of h_forwards and the
    student's dx at every site but the stem."""
    per = (path_launches(H_REMAT_SITES, H_REMAT_NORMS, 3, True),
           path_launches(H_DENSIFY_SITES, H_DENSIFY_NORMS, 2, True, stem=False))
    return {k: micro * sum(p[k] for p in per) for k in COUNT_KEYS}


H_STEP_LAUNCHES = h_step_launches(H_CFG.grad_accum_steps)
H_STEP1_LAUNCHES = h_step_launches(1)  # the grad_accum_steps=1 step at B = 4
H_VAL_LAUNCHES = path_launches(H_SITES, H_NORMS, 1, False)
# STUNetTrainer_huge at 128^3: the stem and 5 a stage in the encoder, 6 a
# stage in the decoder (block 0's conv1 reads the concat, 2C -> C); 2 norms a
# block; every stage under remat
H_SUP_DIMS, H_SUP_RES = (96, 192, 384, 768, 1536, 1536), (128, 64, 32, 16, 8, 4)
H_SUP_SITES = (
    [("enc0.0.conv1", 1, 96, (128,) * 3)]
    + [(f"enc{d}.{b}.conv{i}", c, c, (r,) * 3) for d, (c, r) in enumerate(zip(H_SUP_DIMS, H_SUP_RES))
       for b in range(3) for i in (1, 2) if (b, i) != (0, 1)]
    + [(f"dec{u}.{b}.conv{i}", 2 * c if (b, i) == (0, 1) else c, c, (r,) * 3)
       for u, (c, r) in enumerate(zip(H_SUP_DIMS[-2::-1], H_SUP_RES[-2::-1]))
       for b in range(3) for i in (1, 2)])
H_SUP_NORMS = [(f"{part}{d}.{b}.norm{i}", (r,) * 3, c, False)
               for part, levels in (("enc", zip(H_SUP_DIMS, H_SUP_RES)),
                                    ("dec", zip(H_SUP_DIMS[-2::-1], H_SUP_RES[-2::-1])))
               for d, (c, r) in enumerate(levels) for b in range(3) for i in (1, 2)]
H_SUP_STEP_LAUNCHES = path_launches(H_SUP_SITES, H_SUP_NORMS, 2, True)  # + remat's forward
H_STEPS, H_PROFILED, H_SUP_STEPS = 5, 2, 2


def kernel_launches(c, kernel):
    """A kernel's launches among the counts `c`, a conv's over its variants."""
    return sum(n for k, n in c.items() if k.split(".")[0] == kernel)


def time_ms(f, reps, rounds=3):
    """ms a call: `rounds` runs of `reps` calls back to back, each run between
    its own CUDA events, after a warm-up call; the median of the runs' means,
    so that one stalled call moves one run only."""
    f()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(rounds)]
    for start, end in events:
        start.record()
        for _ in range(reps):
            f()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) / reps for start, end in events)


def bound_ms(C, F, vol, batch=BATCH, itemsize=2):
    voxels = batch * math.prod(vol)
    flops = 2 * voxels * 27 * C * F
    nbytes = (voxels * C + 27 * C * F + voxels * F) * itemsize
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def rel_err(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def conv_inputs(C, F, vol, batch, dtype, gen):
    x = torch.randn((batch, *vol, C), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((3, 3, 3, C, F), generator=gen, device="cuda")
         / math.sqrt(27 * C)).to(dtype)
    return x, w


def check_site(C, F, vol, dtype, gen, tol):
    """Kernel forward and dx (through the autograd Function) against the plain
    version at B = 1. Returns (max abs err, max rel err)."""
    x, w = conv_inputs(C, F, vol, 1, dtype, gen)
    g = torch.randn((1, *vol, F), generator=gen, device="cuda").to(dtype)
    y_k = conv3d_3x3_forward(x, w)
    y_p = conv3d_3x3_plain(x, w)
    xg = x.clone().requires_grad_(True)
    conv3d_3x3(xg, w).backward(g)
    dx_p = conv3d_3x3_plain(g, flip_weight(w))
    torch.cuda.synchronize()
    errs = [rel_err(y_k, y_p), rel_err(xg.grad, dx_p)]
    abs_err = max((y_k.float() - y_p.float()).abs().max().item(),
                  (xg.grad.float() - dx_p.float()).abs().max().item())
    check(all(math.isfinite(e) and e <= tol for e in errs),
          f"kernel vs plain {C}->{F} @{vol} {dtype}: rel errors {errs} > {tol}")
    return abs_err, max(errs)


def time_site(C, F, vol, gen, batch, timed=True):
    """At a main path's batch in bf16: the kernel against the plain version
    (relative max error <= 1e-2), then where `timed` the ms of the kernel,
    the plain version and F.conv3d. Returns (ms, plain ms, F.conv3d ms) or
    None, (max abs err, rel err) and the kernel's variant."""
    x, w = conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
    y_k, y_p = conv3d_3x3_forward(x, w), conv3d_3x3_plain(x, w)
    err = rel_err(y_k, y_p)
    check(math.isfinite(err) and err <= 1e-2,
          f"kernel vs plain {C}->{F} @{vol} B={batch}: rel error {err} > 1e-2")
    abs_err = (y_k.float() - y_p.float()).abs().max().item()
    del y_k, y_p
    if not timed:
        return None, (abs_err, err), igemm_variant(x, w)
    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d memory
    wc = w.permute(4, 3, 0, 1, 2).contiguous()
    ms = time_ms(lambda: conv3d_3x3_forward(x, w), 3)
    plain = time_ms(lambda: conv3d_3x3_plain(x, w), 1)
    lib = time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 3)
    return (ms, plain, lib), (abs_err, err), igemm_variant(x, w)


TOTAL_KEYS = ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms", "bound_ms")


def add_totals(totals, n, ms, plain, lib, flop_ms, byte_ms):
    for k, v in zip(TOTAL_KEYS, (ms, plain, lib, flop_ms, byte_ms, max(flop_ms, byte_ms))):
        totals[k] += n * v


def print_timed(label, batch, timed):
    for (C, F, vol), (ms, plain, lib) in timed.items():
        flop_ms, byte_ms = bound_ms(C, F, vol, batch)
        tflops = 2 * batch * math.prod(vol) * 27 * C * F / ms / 1e9
        by = "operations" if flop_ms >= byte_ms else "bytes"
        print(f"[conv] {label} B={batch} {C:>4}->{F:<3} @{vol}: {ms:.3f} ms "
              f"({tflops:.1f} TFLOP/s), bound {max(flop_ms, byte_ms):.3f} ms ({by}), "
              f"plain {plain:.3f} ms, F.conv3d {lib:.3f} ms")


def conv_phase(gen):
    """Returns max abs err, max rel err, totals for one pretraining step, for
    one inference volume and for one PlainConvUNet tile, the launch shapes it
    checked, and the timings by shape at the step's and at inference's
    batch."""
    max_abs, max_rel = 0.0, 0.0
    shapes = {}
    for name, C, F, vol in SITES:
        for key in ((C, F, vol), (F, C, vol)):  # forward, and the dx conv
            shapes.setdefault(key, []).append(name)
    for (C, F, vol), users in shapes.items():
        a, r = check_site(C, F, vol, torch.bfloat16, gen, 1e-2)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[conv] bf16 {C:>3}->{F:<3} @{vol}: fwd+dx rel err {r:.3e} ({','.join(users)})")
    for C, F, vol in [(1, 32, (32, 32, 32)), (64, 64, (32, 32, 32)), (512, 512, (7, 7, 8)),
                      (256, 128, (28, 28, 32))]:
        _, r = check_site(C, F, vol, torch.float32, gen, 1e-5)
        print(f"[conv] fp32 {C:>3}->{F:<3} @{vol}: fwd+dx rel err {r:.3e}")
    for C, F, vol in CONV_EDGE_SHAPES:
        x, w = conv_inputs(C, F, vol, 1, torch.bfloat16, gen)
        check(igemm_variant(x, w) == "hopper" and igemm_variant(x, flip_weight(w)) == "hopper",
              f"edge shape {C}->{F} @{vol} does not take the hopper variant")
        a, r = check_site(C, F, vol, torch.bfloat16, gen, 1e-2)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[conv] bf16 {C:>3}->{F:<3} @{vol} ({math.prod(vol)} voxels): fwd+dx rel err "
              f"{r:.3e} (hopper edge case)")
    timed = {}
    for key in shapes:
        timed[key], (a, r), variant = time_site(*key, gen, BATCH)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[conv] bf16 {key[0]:>3}->{key[1]:<3} @{key[2]} B={BATCH}: fwd rel err {r:.3e} "
              f"({variant})")
    torch.cuda.empty_cache()
    infer = {}
    for _, C, F, vol in INFER_SITES + PLAIN_INFER_SITES:
        if (C, F, vol) not in infer:
            infer[(C, F, vol)], (a, r), variant = time_site(C, F, vol, gen, TTA_BATCH)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
            print(f"[conv] bf16 {C:>4}->{F:<3} @{vol} B={TTA_BATCH}: fwd rel err {r:.3e} "
                  f"({variant})")
            torch.cuda.empty_cache()
    step = dict.fromkeys(TOTAL_KEYS, 0.0)
    for name, C, F, vol in SITES:
        # per step: teacher and student forwards where kernel #1 runs them
        # (kernel #2 runs the per-tap ones), and the student's dx everywhere
        # but at the stem, whose input carries no gradient
        for key, n in (((C, F, vol), 0 if per_tap(vol) else 2),
                       ((F, C, vol), 0 if name == "enc0.conv1" else 1)):
            add_totals(step, n, *timed[key], *bound_ms(*key))
    volume, plain_tile = dict.fromkeys(TOTAL_KEYS, 0.0), dict.fromkeys(TOTAL_KEYS, 0.0)
    for sites, totals, n in ((INFER_SITES, volume, TILES), (PLAIN_INFER_SITES, plain_tile, 1)):
        for _, C, F, vol in sites:  # one forward a tile
            if not per_tap(vol):
                add_totals(totals, n, *infer[(C, F, vol)], *bound_ms(C, F, vol, TTA_BATCH))
    print_timed("step", BATCH, timed)
    print_timed("inference", TTA_BATCH, infer)
    checked = ({(BATCH, *vol, C, F) for C, F, vol in timed}
               | {(TTA_BATCH, *vol, C, F) for C, F, vol in infer})
    return max_abs, max_rel, step, volume, plain_tile, checked, timed, infer


def zslab_errs(x, w, g):
    """Kernel #2 forward and dx (through its autograd Function) against its
    plain version: (max abs err, max rel err, the shares of bit-equal
    elements of the forward and of dx, the plain forward)."""
    y_k = conv3d_zslab_forward(x, w)
    xg = x.clone().requires_grad_(True)
    dx_k, = torch.autograd.grad(conv3d_zslab(xg, w), xg, g)
    y_p, dx_p = conv3d_zslab_plain(x, w), conv3d_zslab_plain(g, flip_weight(w))
    torch.cuda.synchronize()
    abs_err = max((y_k.float() - y_p.float()).abs().max().item(),
                  (dx_k.float() - dx_p.float()).abs().max().item())
    shares = ((y_k == y_p).float().mean().item(), (dx_k == dx_p).float().mean().item())
    return abs_err, max(rel_err(y_k, y_p), rel_err(dx_k, dx_p)), shares, y_p


def zslab_phase(gen):
    """TPU kernel #2 at the shapes of probes/probe_pallas_v4.py (B = 4, bf16),
    then at three fp32 shapes off them. Returns max abs err, max rel err, the
    totals of the probe path (one forward + dx at each probe shape) and its
    kernel launches."""
    max_abs, max_rel = 0.0, 0.0
    for shape, F in ZSLAB_FP32_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn((3, 3, 3, shape[-1], F), generator=gen, device="cuda") / math.sqrt(
            27 * shape[-1])
        g = torch.randn((*shape[:-1], F), generator=gen, device="cuda")
        a, r, _, _ = zslab_errs(x, w, g)
        check(math.isfinite(r) and r <= 1e-5, f"zslab fp32 {shape}->{F}: rel error {r} > 1e-5")
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[zslab] fp32 {shape}->{F}: fwd+dx rel err {r:.3e}")
    inputs = {}
    for name, C, vol in PROBE_SHAPES:
        x, w = conv_inputs(C, C, vol, BATCH, torch.bfloat16, gen)
        g = torch.randn((BATCH, *vol, C), generator=gen, device="cuda").to(torch.bfloat16)
        a, r, shares, y_p = zslab_errs(x, w, g)
        check(math.isfinite(r) and r <= 1e-2, f"zslab {name} bf16: rel error {r} > 1e-2")
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        # the per-tap rounding: the kernel equals its plain version bit for
        # bit on nearly every element (an fp32 tap sum in another order can
        # round one ulp apart); kernel #1, which rounds once, on far fewer
        y1 = conv3d_3x3_forward(x, w)
        once = (y1 == y_p).float().mean().item()
        check(min(shares) >= 0.95 and once <= min(shares) - 0.1,
              f"zslab {name} bf16: bit-equal shares fwd {shares[0]}, dx {shares[1]}, "
              f"kernel #1 fwd {once}")
        # how far the one-rounding conv (kernel #1) sits from the per-tap rounding
        gap = rel_err(conv3d_zslab_forward(x, w), y1)
        print(f"[zslab] {name} bf16 B={BATCH} {C}->{C} @{vol}: fwd+dx rel err {r:.3e}; "
              f"bit-equal to plain: fwd {shares[0]:.6f}, dx {shares[1]:.6f}, kernel #1 fwd "
              f"{once:.6f}; max|zslab - conv3x3| / max|conv3x3| = {gap:.3e}")
        del y_p, y1
        inputs[name] = (x, w, g)
        torch.cuda.empty_cache()

    def fwd_dx(conv, x, w, g):
        xg = x.detach().requires_grad_(True)
        return lambda: torch.autograd.grad(conv(xg, w), xg, g)

    totals = dict.fromkeys(TOTAL_KEYS, 0.0)
    # the probe path: counts from here on are its launches
    zero_launch_counts(conv3d_zslab)
    for name, C, vol in PROBE_SHAPES:
        x, w, g = inputs.pop(name)
        wf = flip_weight(w)
        ms = time_ms(lambda: conv3d_zslab_forward(x, w), 5)
        ms_dx = time_ms(fwd_dx(conv3d_zslab, x, w, g), 5)
        k1 = time_ms(lambda: conv3d_3x3_forward(x, w), 5)
        k1_dx = time_ms(fwd_dx(conv3d_3x3, x, w, g), 5)
        plain = (time_ms(lambda: conv3d_zslab_plain(x, w), 1)
                 + time_ms(lambda: conv3d_zslab_plain(g, wf), 1))
        xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
        wc, wfc = w.permute(4, 3, 0, 1, 2).contiguous(), wf.permute(4, 3, 0, 1, 2).contiguous()
        lib = (time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 5)
               + time_ms(lambda: fn.conv3d(gc, wfc, None, 1, 1), 5))
        flop_ms, byte_ms = bound_ms(C, C, vol)
        add_totals(totals, 1, ms_dx, plain, lib, 2 * flop_ms, 2 * byte_ms)  # two convs
        tflops = 2 * BATCH * math.prod(vol) * 27 * C * C / 1e9
        print(f"[zslab] {name} B={BATCH} {C}->{C} @{vol}: fwd {ms:.3f} ms "
              f"({tflops / ms:.1f} TFLOP/s), fwd+dx {ms_dx:.3f} ms "
              f"({2 * tflops / ms_dx:.1f} TFLOP/s); bound fwd {max(flop_ms, byte_ms):.3f} ms "
              f"({'operations' if flop_ms >= byte_ms else 'bytes'}); plain fwd+dx "
              f"{plain:.3f} ms; F.conv3d fwd+dx {lib:.3f} ms; kernel #1 fwd {k1:.3f} ms, "
              f"fwd+dx {k1_dx:.3f} ms")
        del x, w, g, wf, xc, gc
        torch.cuda.empty_cache()
    by_variant = dict(conv3d_zslab.launches_by_variant)
    check(by_variant["simple"] == 0 and by_variant["hopper"] == conv3d_zslab.launches,
          f"probe launches by variant {by_variant}: all must be hopper")
    print(f"[zslab] probe path: {conv3d_zslab.launches} launches, by variant {by_variant}")
    return max_abs, max_rel, totals, by_variant


def moments_bound_ms(batch, vol, C, masked, visible, itemsize=2):
    """What this input needs: the rows of x at the `visible` voxels read once
    (a hidden voxel's row is never read), the mask where there is one, the
    two (B, C) fp32 sums written; an add, a multiply and an add per element
    read, at the fp32 rate."""
    n = visible * C
    nbytes = n * itemsize + (batch * math.prod(vol) if masked else 0) + 2 * batch * C * 4
    return 3 * n / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def moments_inputs(batch, vol, C, masked, dtype, gen):
    """x (B, X, Y, Z, C) and, for the step's masked norms, its visibility mask
    as the model makes it: a random keep mask on the 7x7x8 patch grid,
    dilated by mask_to_resolution."""
    x = (torch.randn((batch, *vol, C), generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    if not masked:
        return x, None
    keep = random_keep_mask(batch, FMAP, LEN_KEEP, gen, device="cuda")
    return x, mask_to_resolution(keep, vol)[:, 0]


def moments_err(x, mask, square):
    """Kernel against plain: max over (sample, channel) of |diff| / sum m|x|
    for the sum and |diff| / sum m x^2 for the sum of squares; and that a
    second call gives the same bits."""
    s_k, ss_k = row_moments_forward(x, mask, square)
    again = row_moments_forward(x, mask, square)
    s_p, ss_p = row_moments_plain(x, mask, square)
    scale = row_moments_plain(x.abs(), mask)[0].clamp_min(1e-30)
    torch.cuda.synchronize()
    check(torch.equal(s_k, again[0]) and torch.equal(ss_k, again[1]),
          f"moments kernel {tuple(x.shape)} {x.dtype} square_in_dtype={square}: two calls "
          f"gave different bits")
    rel = max(((s_k - s_p).abs() / scale).max().item(),
              ((ss_k - ss_p).abs() / ss_p.clamp_min(1e-30)).max().item())
    abs_err = max((s_k - s_p).abs().max().item(), (ss_k - ss_p).abs().max().item())
    return abs_err, rel


MOMENTS_PROFILED = 10  # calls a (shape, flag) in the profiler's trace


def device_ms(calls):
    """Device ms of one call of each of `calls` ({label: a function that
    launches the moments kernel once}): the median over MOMENTS_PROFILED
    calls of the kernel's time in one torch.profiler trace. None for every
    label where the trace does not hold exactly those kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for f in calls.values():
            for _ in range(MOMENTS_PROFILED):
                f()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "moments_kernel" in e.name), key=lambda e: e.time_range.start)
    if len(kernels) != MOMENTS_PROFILED * len(calls):
        print(f"[moments] the profiler's trace holds {len(kernels)} kernel events, "
              f"expected {MOMENTS_PROFILED * len(calls)}: device time not measured")
        return dict.fromkeys(calls)
    return {label: statistics.median(
        e.time_range.elapsed_us() / 1e3
        for e in kernels[i * MOMENTS_PROFILED:(i + 1) * MOMENTS_PROFILED])
        for i, label in enumerate(calls)}


def moments_phase(gen):
    """Every norm shape of both paths in bf16 and fp32, with and without
    square_in_dtype (the paths set it): the kernel against its plain version
    and twice against itself. In bf16: the call's time (CUDA events around
    back-to-back calls: host and device) and the kernel's device time
    (torch.profiler), with and without the flag, beside the bound, the plain
    version's time and torch.var_mean's. Returns max abs err, max rel err,
    totals for one pretraining step and for one inference volume (the flag
    set) and for one PlainConvUNet tile, their device-time totals, and the
    launch shapes it checked."""
    shapes = {}
    for batch, norms in ((BATCH, PRETRAIN_NORMS), (TTA_BATCH, INFER_NORMS),
                         (TTA_BATCH, PLAIN_INFER_NORMS)):
        for name, vol, C, masked in norms:
            shapes.setdefault((batch, vol, C, masked), []).append(name)
    max_abs, max_rel, timed, calls = 0.0, 0.0, {}, {}
    for key, users in shapes.items():
        batch, vol, C, masked = key
        for dtype in (torch.bfloat16, torch.float32):
            x, mask = moments_inputs(batch, vol, C, masked, dtype, gen)
            for square in (False, True):
                a, r = moments_err(x, mask, square)
                check(math.isfinite(r) and r <= 1e-5,
                      f"moments kernel vs plain {key} {dtype} square_in_dtype={square}: "
                      f"rel error {r} > 1e-5")
                max_abs, max_rel = max(max_abs, a), max(max_rel, r)
                print(f"[moments] {str(dtype)[6:]:>8} B={batch} {vol} C={C:<3} "
                      f"{'masked' if masked else 'plain '} square_in_dtype={square:d}: rel err "
                      f"{r:.3e}, two calls bit-equal ({','.join(users)})")
            if dtype == torch.bfloat16:
                ms = [time_ms(lambda: row_moments_forward(x, mask, sq), 20) for sq in (False, True)]
                # the scratch is sized by now: a call allocates its (2, B, C) output alone
                before = torch.cuda.memory_stats()["allocation.all.allocated"]
                for _ in range(5):
                    row_moments_forward(x, mask, True)
                n_alloc = torch.cuda.memory_stats()["allocation.all.allocated"] - before
                check(n_alloc == 5, f"moments {key}: {n_alloc} allocations in 5 calls, expected 5")
                plain = time_ms(lambda: row_moments_plain(x, mask, True), 3)
                lib = time_ms(lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0), 5)
                visible = int(mask.sum()) if masked else batch * math.prod(vol)
                timed[key] = (ms, plain, lib, visible)
                for sq in (False, True):
                    calls[(key, sq)] = (lambda x=x, mask=mask, sq=sq:
                                        row_moments_forward(x, mask, sq))
            else:
                del x, mask
        torch.cuda.empty_cache()
    dev = device_ms(calls)
    calls.clear()
    torch.cuda.empty_cache()
    # off the main paths: element loads (C not a multiple of 16 bytes), more
    # channels than one block's tile of 32 vector columns, a ragged last
    # group, a mask read byte by byte (V % 8 != 0)
    for batch, vol, C, masked in ((2, (5, 6, 7), 3, True), (3, (9, 9, 9), 12, False),
                                  (2, (7, 7, 8), 4096, True), (1, (33, 35, 37), 8, False)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((batch, *vol, C), generator=gen, device="cuda") + 0.5).to(dtype)
            mask = (torch.rand((batch, *vol), generator=gen, device="cuda") > 0.4
                    if masked else None)
            for square in (False, True):
                a, r = moments_err(x, mask, square)
                check(math.isfinite(r) and r <= 1e-5,
                      f"moments kernel vs plain {(batch, vol, C, masked)} {dtype} "
                      f"square_in_dtype={square}: rel error {r}")
                max_abs, max_rel = max(max_abs, a), max(max_rel, r)
                print(f"[moments] {str(dtype)[6:]:>8} B={batch} {vol} C={C:<4} "
                      f"{'masked' if masked else 'plain '} square_in_dtype={square:d}: rel err "
                      f"{r:.3e}, two calls bit-equal (edge case)")

    def totals(batch, norms, n):
        t, d = dict.fromkeys(TOTAL_KEYS, 0.0), 0.0
        for _, vol, C, masked in norms:
            key = (batch, vol, C, masked)
            ms, plain, lib, visible = timed[key]
            add_totals(t, n, ms[1], plain, lib, *moments_bound_ms(*key, visible))
            d = None if d is None or dev[(key, True)] is None else d + n * dev[(key, True)]
        return t, d

    step, step_dev = totals(BATCH, PRETRAIN_NORMS, 2)  # teacher and student forwards
    volume, volume_dev = totals(TTA_BATCH, INFER_NORMS, TILES)  # one forward a tile
    plain_tile, plain_tile_dev = totals(TTA_BATCH, PLAIN_INFER_NORMS, 1)
    for key, (ms, plain, lib, visible) in timed.items():
        batch, vol, C, masked = key
        flop_ms, byte_ms = moments_bound_ms(*key, visible)
        nbytes = byte_ms * PEAK_BYTES / 1e3
        all_bytes = batch * math.prod(vol) * C * 2 + 2 * batch * C * 4  # var_mean reads every row
        for sq in (False, True):
            d = dev[(key, sq)]
            device = "not measured" if d is None else f"{d:.4f} ms ({nbytes / d / 1e6:.0f} GB/s)"
            print(f"[moments] B={batch} {vol} C={C:<3} {'masked' if masked else 'plain '} "
                  f"square_in_dtype={sq:d}: call {ms[sq]:.4f} ms "
                  f"({nbytes / ms[sq] / 1e6:.0f} GB/s), "
                  f"device {device}, bound {max(flop_ms, byte_ms):.4f} ms "
                  f"({'bytes' if byte_ms >= flop_ms else 'operations'}); plain {plain:.4f} ms, "
                  f"var_mean {lib:.4f} ms ({all_bytes / lib / 1e6:.0f} GB/s)")
    print(f"[moments] step (44 calls, flag set): call {step['ms']:.3f} ms, device "
          f"{'not measured' if step_dev is None else f'{step_dev:.3f} ms'}, bound "
          f"{step['bound_ms']:.3f} ms, var_mean {step['library_ms']:.3f} ms; volume "
          f"({len(INFER_NORMS) * TILES} calls): call {volume['ms']:.3f} ms, device "
          f"{'not measured' if volume_dev is None else f'{volume_dev:.3f} ms'}, bound "
          f"{volume['bound_ms']:.3f} ms, var_mean {volume['library_ms']:.3f} ms; PlainConvUNet "
          f"tile ({len(PLAIN_INFER_NORMS)} calls): call {plain_tile['ms']:.3f} ms, device "
          f"{'not measured' if plain_tile_dev is None else f'{plain_tile_dev:.3f} ms'}, bound "
          f"{plain_tile['bound_ms']:.3f} ms, var_mean {plain_tile['library_ms']:.3f} ms")
    checked = {(b, *vol, C, masked, sq) for b, vol, C, masked in timed for sq in (False, True)}
    return (max_abs, max_rel, (step, step_dev), (volume, volume_dev),
            (plain_tile, plain_tile_dev), checked)


def zconcat_site(C, F, vol, batch, gen, dx, timed=True):
    """Kernel #2's forward at one path shape, and with `dx` the dx through
    conv3d_zconcat (kernel #1, rounded once), against the plain versions:
    rel. max error <= 1e-2, bit-equal to plain on >= 95% of the elements,
    kernel #1's forward (one rounding) at least 10 points fewer. Returns max
    abs err, max rel err, the bit-equal shares (fwd[, dx]), kernel #1's
    share, the variant, and (ms, plain ms, F.conv3d ms) where `timed`, else
    None."""
    x, w = conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
    variant = igemm_variant(x, w)
    y_k, y_p = conv3d_zslab_forward(x, w), conv3d_zslab_plain(x, w)
    once = (conv3d_3x3_forward(x, w) == y_p).float().mean().item()
    errs, shares = [rel_err(y_k, y_p)], [(y_k == y_p).float().mean().item()]
    abs_err = (y_k.float() - y_p.float()).abs().max().item()
    del y_k, y_p
    if dx:
        g = torch.randn((batch, *vol, F), generator=gen, device="cuda").to(torch.bfloat16)
        xg = x.detach().requires_grad_(True)
        dx_k, = torch.autograd.grad(conv3d_zconcat(xg, w), xg, g)
        dx_p = conv3d_3x3_plain(g, flip_weight(w))
        errs.append(rel_err(dx_k, dx_p))
        shares.append((dx_k == dx_p).float().mean().item())
        abs_err = max(abs_err, (dx_k.float() - dx_p.float()).abs().max().item())
        del g, xg, dx_k, dx_p
    torch.cuda.synchronize()
    check(all(math.isfinite(e) and e <= 1e-2 for e in errs),
          f"zslab {C}->{F} @{vol} B={batch}: rel errors {errs} > 1e-2")
    check(min(shares) >= 0.95 and once <= shares[0] - 0.1,
          f"zslab {C}->{F} @{vol} B={batch}: bit-equal shares (fwd, dx) {shares}, "
          f"kernel #1 fwd {once}")
    times = None
    if timed:
        xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
        times = (time_ms(lambda: conv3d_zslab_forward(x, w), 3),
                 time_ms(lambda: conv3d_zslab_plain(x, w), 1),
                 time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 3))
        del xc, wc
    del x, w
    torch.cuda.empty_cache()
    return abs_err, max(errs), shares, once, variant, times


def zconcat_phase(gen, k1_step, k1_infer):
    """Kernel #2 at every shape where the main paths run it (ConvND's per-tap
    forwards, >= MIN_VOLUME output voxels): at the step's B = 4 the forward
    and dx through conv3d_zconcat (dx is kernel #1, rounded once) against
    the plain versions, at inference's B = 8 the forward (zconcat_site's
    gates). Then the forward's time beside kernel #1's at the same shape
    (conv phase), the bound, the plain version's and F.conv3d's. Returns max
    abs err, max rel err, the totals of one step, one volume and one
    PlainConvUNet tile (kernel #2's forwards) and the launch shapes it
    checked."""
    max_abs, max_rel, timed = 0.0, 0.0, {}
    for batch, sites, k1 in ((BATCH, SITES, k1_step),
                             (TTA_BATCH, INFER_SITES + PLAIN_INFER_SITES, k1_infer)):
        for C, F, vol in sorted({(C, F, vol) for _, C, F, vol in sites if per_tap(vol)}):
            abs_err, err, shares, once, variant, (ms, plain, lib) = zconcat_site(
                C, F, vol, batch, gen, dx=batch == BATCH and C > 1)
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, err)
            timed[(batch, C, F, vol)] = (ms, plain, lib)
            flop_ms, byte_ms = bound_ms(C, F, vol, batch)
            tflops = 2 * batch * math.prod(vol) * 27 * C * F / ms / 1e9
            print(f"[zslab] path B={batch} {C:>3}->{F:<3} @{vol} ({variant}): rel err "
                  f"{err:.3e}, bit-equal to plain fwd {shares[0]:.6f}"
                  f"{f', dx {shares[1]:.6f}' if len(shares) > 1 else ''}, kernel #1 fwd "
                  f"{once:.6f}; fwd {ms:.3f} ms ({tflops:.1f} TFLOP/s), kernel #1 "
                  f"{k1[(C, F, vol)][0]:.3f} ms, bound {max(flop_ms, byte_ms):.3f} ms, plain "
                  f"{plain:.3f} ms, F.conv3d {lib:.3f} ms")
    step, volume, plain_tile = (dict.fromkeys(TOTAL_KEYS, 0.0) for _ in range(3))
    for batch, sites, totals, n in ((BATCH, SITES, step, 2),
                                    (TTA_BATCH, INFER_SITES, volume, TILES),
                                    (TTA_BATCH, PLAIN_INFER_SITES, plain_tile, 1)):
        for _, C, F, vol in sites:
            if per_tap(vol):
                add_totals(totals, n, *timed[(batch, C, F, vol)], *bound_ms(C, F, vol, batch))
    print(f"[zslab] path: step {step['ms']:.3f} ms (bound {step['bound_ms']:.3f}, F.conv3d "
          f"{step['library_ms']:.3f}), volume {volume['ms']:.3f} ms (bound "
          f"{volume['bound_ms']:.3f}, F.conv3d {volume['library_ms']:.3f}), PlainConvUNet "
          f"tile {plain_tile['ms']:.3f} ms (bound {plain_tile['bound_ms']:.3f}, F.conv3d "
          f"{plain_tile['library_ms']:.3f})")
    checked = {(b, *vol, C, F) for b, C, F, vol in timed}
    return max_abs, max_rel, step, volume, plain_tile, checked


class LaunchShapes:
    """Records the shape of every kernel launch while it is on: each conv's
    (B, X, Y, Z, C, F) and the moments' (B, X, Y, Z, C, masked,
    square_in_dtype). It wraps each module's launch function and leaves the
    launch counts to the wrappers; `paused` is a stretch whose launches (a
    gate's, inside a path's phase) it does not record."""

    def __init__(self):
        self.conv, self.zslab, self.moments = set(), set(), set()
        self.on = True
        conv_launch, zslab_launch = conv_mod._launch, zslab_mod._launch
        moments_launch = moments_mod._launch

        def conv(x, w):
            if self.on:
                self.conv.add((*x.shape, w.shape[-1]))
            return conv_launch(x, w)

        def zslab(x, w):
            if self.on:
                self.zslab.add((*x.shape, w.shape[-1]))
            return zslab_launch(x, w)

        def moments(x, mask, square_in_dtype):
            if self.on:
                self.moments.add((*x.shape, mask is not None, square_in_dtype))
            return moments_launch(x, mask, square_in_dtype)

        conv_mod._launch, zslab_mod._launch, moments_mod._launch = conv, zslab, moments

    @contextmanager
    def paused(self):
        self.on = False
        try:
            yield
        finally:
            self.on = True


def reference_phase():
    """Tiny pretraining models in fp32: the card (kernels) against the CPU
    (plain), rel. error <= 1e-4: the SparK (STUNet encoder dims 4-64), with
    densify norm "bn", with "ln", in the batch-pooled reference-fidelity mode
    (decoder norm "bn"), and with the MedNeXt encoder; the three ablation
    decoders and SparseConvNeXtBlock on their own."""
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((2, 1, 32, 32, 32), generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    small = dict(patch_size=(32, 32, 32), encoder_dims=(4, 8, 16, 32, 64),
                 compute_dtype="float32")
    configs = {"SparK": {}, "SparK densify bn": dict(densify_norm="bn"),
               "SparK densify ln": dict(densify_norm="ln"),
               "SparK pooled, decoder bn": dict(norm_batch_pooled=True, decoder_norm="bn"),
               "SparK MedNeXt": dict(encoder_type="mednext", encoder_dims=(4,))}
    worst = 0.0

    def compare(label, make, *args):
        nonlocal worst
        cpu = make()
        gpu = copy.deepcopy(cpu).to("cuda")
        with torch.no_grad():
            out_c = cpu(*args)
            out_g = gpu(*([v.cuda() for v in a] if isinstance(a, list) else a.cuda()
                          for a in args))
        outs = [(o_g.cpu(), o_c) for o_g, o_c in zip(
            out_g if isinstance(out_g, (list, tuple)) else [out_g],
            out_c if isinstance(out_c, (list, tuple)) else [out_c])]
        err = max(rel_err(g, c_) for g, c_ in outs)
        check(math.isfinite(err) and err <= 1e-4, f"tiny {label} card vs CPU rel err {err}")
        print(f"[slice] tiny {label} fp32, card vs CPU: rel err {err:.3e}")
        worst = max(worst, err)

    for label, kw in configs.items():
        cfg = PretrainConfig(**{**small, **kw})
        cpu = build_spark_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        mask = random_keep_mask(2, cpu.fmap, cpu.len_keep, gen, device="cpu")
        compare(label, lambda: cpu, x, mask)
    feats = [torch.randn((2, 16, 2, 2, 2), generator=gen),
             torch.randn((2, 8, 4, 4, 4), generator=gen)]
    g5 = torch.Generator().manual_seed(5)
    compare("DSDecoder", lambda: DSDecoder(4, width=16, norm="bn", generator=g5), feats)
    compare("SMiMDecoder", lambda: SMiMDecoder(16, 16, width=16, generator=g5), feats[:1])
    compare("SMiMTwoDecoder", lambda: SMiMTwoDecoder(16, 16, width=64, generator=g5), feats[:1])
    keep = torch.rand((2, 1, 4, 4, 4), generator=gen) > 0.4
    y = torch.randn((2, 8, 8, 8, 8), generator=gen) * upsample_mask(keep, (2, 2, 2))
    compare("SparseConvNeXtBlock", lambda: SparseConvNeXtBlock(8, generator=g5), y, keep)
    return worst


def remat_phase():
    """Activation checkpointing on the card: one backward of a tiny SparK
    (3 stages at depth 2 with remat, patch 32^3; dims 4-16 in fp32, 32-64
    in bf16 so that the hopper variants run) and of a tiny supervised STUNet
    (depth 2; dims 4-16 in fp32, 32-64 in bf16), each twice without remat
    and once with it. The three gradients must be bit-equal (cuDNN held to
    its deterministic algorithms for the comparison), and the remat run must
    launch every kernel of its forward again inside its backward. In fp32
    the remat gradients must agree with the CPU's (plain versions): the
    largest difference over all leaves within 1e-4 of the step's largest
    gradient, and each leaf within half its own largest entry. Three stages,
    not five: at five the 2^3 patch grid leaves 3 visible voxels a sample to
    the coarsest norms, and round-off alone (two CPU thread counts) moves
    the gradients past that limit."""
    gen = torch.Generator().manual_seed(9)
    x = torch.rand((2, 1, 32, 32, 32), generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    small = dict(patch_size=(32, 32, 32), encoder_depth=(2,) * 3)
    sparks = {"SparK fp32": dict(small, encoder_dims=(4, 8, 16), compute_dtype="float32"),
              "SparK bf16": dict(small, encoder_dims=(32, 64, 64))}

    def spark(kw, remat):
        return build_spark_model(PretrainConfig(**kw, remat=remat), device="cpu",
                                 generator=torch.Generator().manual_seed(5))

    tiny = spark(sparks["SparK fp32"], False)
    keep = random_keep_mask(2, tiny.fmap, tiny.len_keep, gen, device="cpu")

    def stunet(dims, dtype, remat):
        return STUNet(1, 3, depth=(2,) * 4, dims=dims, pool_op_kernel_sizes=[(2, 2, 2)] * 3,
                      dtype=dtype, generator=torch.Generator().manual_seed(5), remat=remat)

    def spark_loss_of(model, inp, mask):
        return spark_loss(*model(inp, mask), mask)[0]

    def stunet_loss_of(model, inp):
        return sum(o.float().square().mean() for o in model(inp))

    cases = [(label, lambda r, kw=kw: spark(kw, r), spark_loss_of, (x, keep),
              kw.get("compute_dtype") == "float32") for label, kw in sparks.items()]
    cases += [(f"STUNet {name}", lambda r, n=n, d=d: stunet(n, d, r), stunet_loss_of, (x,),
               d == torch.float32) for name, n, d in (("fp32", (4, 8, 16, 16), torch.float32),
                                                     ("bf16", (32, 64, 64, 64), torch.bfloat16))]
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    worst = 0.0
    try:
        for label, make, loss_of, args, fp32 in cases:
            grads, launches = [], []
            for remat in (False, False, True):
                model = make(remat).to("cuda")
                inputs = [a.to("cuda") for a in args]
                if not fp32:
                    inputs[0] = inputs[0].to(torch.bfloat16)
                before = counts()
                loss_of(model, *inputs).backward()
                torch.cuda.synchronize()
                launches.append(since(before))
                grads.append({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                              for n, p in model.named_parameters()})
            for k in grads[0]:
                check(torch.equal(grads[1][k], grads[0][k]),
                      f"remat {label}: {k} differs between two runs without remat")
                check(torch.equal(grads[2][k], grads[0][k]),
                      f"remat {label}: {k} differs with remat")
            check(launches[1] == launches[0], f"remat {label}: launches {launches[:2]}")
            by_kernel = [{k: sum(n for v, n in c.items() if v.startswith(k))
                          for k in ("conv3x3", "zslab", "moments")} for c in launches]
            again = {k: by_kernel[2][k] - by_kernel[0][k] for k in by_kernel[0]}
            check(all(by_kernel[0].values()) and all(n > 0 for n in again.values()),
                  f"remat {label}: launches without remat {launches[0]}, with {launches[2]}")
            line = (f"[remat] {label}: gradients bit-equal with and without remat over "
                    f"{len(grads[0])} leaves; launches without remat {launches[0]}, "
                    f"again in the remat backward {again}")
            if fp32:
                cpu = make(True)
                loss_of(cpu, *args).backward()
                want = {n: torch.zeros_like(p) if p.grad is None else p.grad
                        for n, p in cpu.named_parameters()}
                scale = max(g.abs().max().item() for g in want.values())
                diff = {k: (grads[2][k].cpu() - g).abs().max().item() for k, g in want.items()}
                err = max(diff.values()) / scale
                leaf = max(diff[k] / g.abs().max().item() for k, g in want.items()
                           if g.abs().max().item() > 1e-6 * scale)
                check(math.isfinite(err) and err <= 1e-4 and leaf <= 0.5,
                      f"remat {label}: card vs CPU gradients {err} of the largest, "
                      f"a leaf {leaf} of its own")
                line += (f"; card vs CPU {err:.3e} of the largest gradient (a leaf at worst "
                         f"{leaf:.3e} of its own)")
                worst = max(worst, err)
            print(line)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    return worst


def slice_phase():
    cfg = PretrainConfig()
    student = build_spark_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    teacher = make_teacher(student)
    optimizer = make_optimizer(student)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((BATCH, 1, *cfg.patch_size), generator=gen, device="cuda")
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    L = math.prod(student.fmap)
    len_loss = int((L - student.len_keep) * 0.25)
    check(student.fmap == FMAP and student.len_keep == LEN_KEEP and len_loss == 58,
          f"main-path sizes {student.fmap} {student.len_keep} {len_loss}")
    n_params = sum(p.numel() for p in student.parameters())
    print(f"[slice] STUNet-B SparK, {n_params} parameters, patch {cfg.patch_size}, "
          f"batch {BATCH}, bf16; fmap {student.fmap}, keep {student.len_keep}, "
          f"forced {len_loss}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    # counts from here on belong to the pretraining path
    zero_counts()
    for step in range(STEPS):
        before = counts()
        old = [p.detach().clone() for p in teacher.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, hard, loss_map = anatomask_train_step(student, teacher, optimizer, x,
                                                    len_loss, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), f"step {step}: loss {losses[-1]}")
        hard = hard.reshape(BATCH, L)
        check(hard.sum(1).tolist() == [student.len_keep] * BATCH,
              f"step {step}: kept {hard.sum(1).tolist()}")
        top = torch.topk(loss_map, len_loss, dim=1).indices
        check(not torch.gather(hard, 1, top).any(), f"step {step}: a forced patch is kept")
        # two forwards (teacher, student) of 17 convs and 22 norms and the
        # student's dx: 34 on kernel #1, all hopper; 16 on kernel #2, of which
        # the stem's two (C = 1) simple; 44 moments
        n = since(before)
        check(n == STEP_LAUNCHES, f"step {step}: launches {n}, expected {STEP_LAUNCHES}")
        moved = False
        for e, o, p in zip(teacher.parameters(), old, student.parameters()):
            want = o + 0.001 * (p.detach() - o)
            check((e - want).abs().max().item() <= 1e-6, f"step {step}: EMA law broken")
            moved = moved or not torch.equal(e, o)
        check(moved, f"step {step}: the teacher did not move")
        print(f"[slice] step {step}: loss {losses[-1]:.6f}, {times[-1]:.1f} ms, launches {n}")
    launches = counts()
    step_ms = statistics.median(times[WARMUP:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] step {step_ms:.1f} ms (median of {STEPS - WARMUP}), "
          f"{BATCH / step_ms * 1e3:.3f} patches/s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak} bytes), launches in {STEPS} steps {launches}")
    return launches, step_ms


def inference_reference_phase():
    """A tiny STUNet, PlainConvUNet (instance and batch norm) and
    ResidualEncoderUNet in fp32 through both sliding-window paths (mirror
    TTA, 8 tiles in batches of 3, the last padded): the card (kernels)
    against the CPU (plain)."""
    # pools chosen so that the bottom level keeps 4x4x8 voxels of a 32^3 tile
    pools = [(2, 2, 2), (2, 2, 2), (2, 2, 1), (1, 1, 1), (1, 1, 1)]
    unet = dict(input_channels=1, num_classes=3, n_stages=4, features_per_stage=(4, 8, 16, 32),
                kernel_sizes=[(3, 3, 3)] * 4, strides=[(1, 1, 1)] + pools[:3],
                n_conv_per_stage_decoder=(2, 1, 2), deep_supervision=False)
    nets = {
        "STUNet": lambda g: STUNet(1, 3, dims=(4, 8, 16, 16, 32, 32), pool_op_kernel_sizes=pools,
                                   deep_supervision=False, generator=g),
        "PlainConvUNet": lambda g: PlainConvUNet(n_conv_per_stage=(2, 1, 2, 2), generator=g,
                                                 **unet),
        "PlainConvUNet, BatchNorm": lambda g: PlainConvUNet(n_conv_per_stage=(2, 1, 2, 2),
                                                            norm="batch", generator=g, **unet),
        "ResidualEncoderUNet": lambda g: ResidualEncoderUNet(n_blocks_per_stage=(1, 2, 1, 1),
                                                             generator=g, **unet),
    }
    data = np.random.RandomState(8).rand(1, 45, 40, 33).astype(np.float32)

    def tile_fn(net):
        return make_tile_predictor(
            lambda x: net(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1), (0, 1, 2))

    kw = dict(tile_size=(32, 32, 32), num_output_channels=3, tile_batch_size=3)
    worst = 0.0
    for name, make in nets.items():
        cpu = make(torch.Generator().manual_seed(7)).eval()
        gpu = copy.deepcopy(cpu).to("cuda")
        ref = sliding_window_predict_device_resident(data, tile_fn(cpu), device="cpu", **kw)
        errs = [float(np.abs(got - ref).max() / np.abs(ref).max())
                for got in (sliding_window_predict_device_resident(data, tile_fn(gpu), **kw),
                            sliding_window_predict(data, tile_fn(gpu), **kw))]
        check(all(math.isfinite(e) and e <= 1e-4 for e in errs),
              f"tiny {name} card vs CPU rel errs {errs}")
        print(f"[inference] tiny {name} fp32, card vs CPU: rel err device-resident "
              f"{errs[0]:.3e}, streaming {errs[1]:.3e}")
        worst = max(worst, *errs)
    return worst


def inference_phase():
    """bench_inference.py's configuration through the Predictor."""
    plans = {"dataset_name": "Dataset000_BraTSLike", "plans_name": "chipSmokePlans",
             "configurations": {"3d_fullres": {
                 "patch_size": list(PATCH), "UNet_class_name": "STUNet-B",
                 "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 5,
                 "conv_kernel_sizes": [[3, 3, 3]] * 6}}}
    dataset_json = {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "MR"}}
    pm = PlansManager(plans)
    cm = pm.get_configuration("3d_fullres")
    net = build_network_from_plans(pm, cm, 1, NUM_CLASSES, deep_supervision=False,
                                   dtype=torch.bfloat16, device="cuda",
                                   generator=torch.Generator().manual_seed(0))
    predictor = Predictor(tile_step_size=0.5, use_mirroring=True, tile_batch_size=1,
                          dtype=torch.bfloat16, device="cuda")
    predictor.manual_initialization(net, pm, cm, [net.state_dict()], dataset_json, (0, 1, 2))
    tiles = math.prod(len(s) for s in compute_steps_for_sliding_window(VOLUME, PATCH, 0.5))
    check(tiles == TILES, f"{tiles} tiles, expected {TILES}")
    n_params = sum(p.numel() for p in net.parameters())
    print(f"[inference] STUNet-B, {n_params} parameters, volume {VOLUME}, patch {PATCH}, "
          f"{tiles} tiles, 8-flip TTA, tile batch 1, bf16")
    data = np.random.RandomState(0).rand(1, *VOLUME).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, first = [], None
    # counts from here on belong to the inference path
    zero_counts()
    for v in range(VOLUMES):
        before = counts()
        t0 = time.perf_counter()
        logits = predictor.predict_sliding_window_return_logits(data)
        times.append(time.perf_counter() - t0)
        n = since(before)
        check(logits.shape == (NUM_CLASSES, *VOLUME), f"volume {v}: logits {logits.shape}")
        check(bool(np.isfinite(logits).all()), f"volume {v}: non-finite logits")
        # a tile: 7 convs on kernel #1, 10 on kernel #2 (the stem simple), 22 norms
        want = {k: TILES * n_tile for k, n_tile in TILE_LAUNCHES.items()}
        check(n == want, f"volume {v}: launches {n}, expected {want}")
        first = logits if first is None else first
        print(f"[inference] volume {v}: {times[-1]:.3f} s, launches {n}, logits mean "
              f"{float(logits.mean()):.6f}, max |diff| to volume 0 "
              f"{float(np.abs(logits - first).max()):.3e}")
    launches = counts()
    volume_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[inference] {volume_s:.3f} s a volume (median of {VOLUMES - 1}), "
          f"{1 / volume_s:.4f} volumes/s, {TILES / volume_s:.2f} tiles/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes), launches in {VOLUMES} volumes {launches}")
    return launches


def write_trainer_dataset(root):
    """A preprocessed dataset as the preprocessor leaves it, written with the
    port's own code: TRAINER_CASES cases of 1 x 160^3 fp32 (noise with one
    brighter sphere, labelled 1) as <key>.npz, their properties with
    class_locations, dataset.json and ATKPlans.json."""
    base = os.path.join(root, "preprocessed", TRAINER_DATASET)
    folder = os.path.join(base, "ATKPlans_3d_fullres")
    os.makedirs(folder)
    rs = np.random.default_rng(0)
    axes = np.ogrid[tuple(slice(0, s) for s in TRAINER_CASE_SHAPE)]
    for i in range(TRAINER_CASES):
        data = rs.standard_normal((1, *TRAINER_CASE_SHAPE), dtype=np.float32)
        c, r = rs.integers(40, 120, 3), rs.integers(10, 25)
        blob = sum((a - ci) ** 2 for a, ci in zip(axes, c)) < r ** 2
        data[0][blob] += 2.0
        seg = blob[None].astype(np.int8)
        key = os.path.join(folder, f"case_{i:03d}")
        np.savez(key + ".npz", data=data, seg=seg)
        locs = np.argwhere(seg == 1)
        locs = locs[rs.choice(len(locs), min(len(locs), 10000), replace=False)]
        save_properties({"spacing": [1.0, 1.0, 1.0], "class_locations": {1: locs}}, key)
    save_json({"channel_names": {"0": "CT"}, "labels": {"background": 0, "sphere": 1},
               "numTraining": TRAINER_CASES, "file_ending": ".nii.gz"},
              os.path.join(base, "dataset.json"))
    save_json({"dataset_name": TRAINER_DATASET, "plans_name": "ATKPlans",
               "configurations": {"3d_fullres": {
                   "data_identifier": "ATKPlans_3d_fullres",
                   "patch_size": list(PretrainConfig().patch_size), "spacing": [1.0] * 3}}},
              os.path.join(base, "ATKPlans.json"))


def trainer_run(cfg, continue_training=False, output_folder=None, trainer=None,
                step=STEP_LAUNCHES, val=VAL_LAUNCHES):
    """One run_pretraining (of `trainer`, else a new one) with the counts at
    0, a training step launching `step`, a validation step `val`; returns
    the trainer, its history, the conv and moments launches and the peak
    memory."""
    trainer = trainer or PretrainTrainer(TRAINER_DATASET, cfg, device="cuda",
                                         output_folder=output_folder)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    history = trainer.run_pretraining(continue_training=continue_training)
    launches = counts()
    check(all(math.isfinite(v) for k in history for v in history[k]),
          f"non-finite losses {history}")
    epochs = len(history["train_loss"])
    iters = trainer.iters_per_epoch
    n_val = epochs * max(1, iters // 5)
    # a training step launches as the bare step does, a val step one forward
    steps = epochs * iters
    want = {k: steps * step[k] + n_val * val[k] for k in COUNT_KEYS}
    check(launches == want, f"trainer launches {launches}, expected {want}")
    return trainer, history, launches, torch.cuda.max_memory_allocated()


def check_cache_slots(cache):
    """Every slot of a case cache whose window covers whole cases holds its
    case: the case's array at the slot's offset in zeros, in the cache dtype."""
    for s, meta in enumerate(cache.meta):
        data = np.asarray(cache.dataset.load_case(meta.key)[0])
        check(tuple(meta.extent) == data.shape[1:], f"slot {s}: window {meta.extent}")
        want = torch.zeros((*cache.slot_shape, cache.num_channels), dtype=cache.dtype)
        box = tuple(slice(int(o), int(o + e)) for o, e in zip(meta.offset, meta.extent))
        want[box] = torch.from_numpy(np.moveaxis(data, 0, -1)).to(cache.dtype)
        check(torch.equal(cache.cache[s].cpu(), want), f"slot {s} does not hold {meta.key}")


def trainer_phase(bare_step_ms, keep):
    """PretrainTrainer.run_pretraining at full STUNet-B width: 2 epochs x 5
    iterations with the GPU case cache, then a resume from checkpoint_latest
    for 1 epoch x 2 iterations through the host pipeline, then one for 1
    epoch x 6 iterations with a case cache that refills. Returns the launch
    counts of the three runs; the last run's checkpoint_final.pt is copied to
    `keep` for the supervised phase."""
    with tempfile.TemporaryDirectory() as root:
        write_trainer_dataset(root)
        for which in ("preprocessed", "results"):
            os.environ[f"ATK_{which}"] = os.path.join(root, which)
        cfg = PretrainConfig(method="anatomask", batch_size=BATCH, num_epochs=TRAINER_EPOCHS,
                             iters_per_epoch=TRAINER_ITERS, device_cache=True)
        t, history, launches, peak = trainer_run(cfg)
        check(t.device_cache is not None and t.device_cache.whole_dataset_resident,
              "the training cases are not all resident in the case cache")
        print(f"[trainer] STUNet-B, patch {cfg.patch_size} from initial patch "
              f"{tuple(int(v) for v in t.device_cache.initial_patch)}, batch {BATCH}, bf16, "
              f"{t.n_train} training cases in {t.device_cache.num_slots} cache slots of "
              f"{t.device_cache.slot_shape}; losses {history}")
        for e in t.epoch_timings:
            print(f"[trainer] epoch {e['epoch']}: {e['total']:.3f} s (train {e['train']:.3f} s, "
                  f"fetch-wait {e['fetch_wait']:.3f} s, val {e['val']:.3f} s, "
                  f"checkpoint {e['ckpt']:.3f} s)")
        last = t.epoch_timings[-1]
        step_ms = last["train"] / TRAINER_ITERS * 1e3
        print(f"[trainer] epoch {last['epoch']} training loop: {BATCH * TRAINER_ITERS / last['train']:.3f} "
              f"patches/s, {step_ms:.1f} ms a step through the trainer (bare step "
              f"{bare_step_ms:.1f} ms); peak memory {peak / 2**30:.2f} GiB ({peak} bytes); "
              f"launches {launches}")
        for f in ("checkpoint_latest.pt", "B_head_latest.pt", "checkpoint_best.pt",
                  "checkpoint_final.pt", "history.json"):
            check(os.path.isfile(os.path.join(t.output_folder, f)), f"no {f}")

        resume = replace(cfg, num_epochs=TRAINER_EPOCHS + 1, iters_per_epoch=2,
                         device_cache=False)
        t2, history2, launches2, peak2 = trainer_run(resume, True, t.output_folder)
        check(t2.current_epoch == TRAINER_EPOCHS and len(history2["train_loss"]) == 1,
              f"resume ran epochs {t2.current_epoch}, history {history2}")
        e = t2.epoch_timings[-1]
        print(f"[trainer] resumed at epoch {e['epoch']} from checkpoint_latest, host pipeline: "
              f"{e['total']:.3f} s (train {e['train']:.3f} s, fetch-wait {e['fetch_wait']:.3f} s, "
              f"val {e['val']:.3f} s); losses {history2}; peak memory {peak2 / 2**30:.2f} GiB; "
              f"launches {launches2}")
        del t2

        refill = replace(cfg, num_epochs=TRAINER_EPOCHS + 2, iters_per_epoch=REFILL_ITERS,
                         device_cache_mb=REFILL_CACHE_MB)
        t3, history3, launches3, peak3 = trainer_run(refill, True, t.output_folder)
        cache = t3.device_cache
        check(t3.current_epoch == TRAINER_EPOCHS + 1 and len(history3["train_loss"]) == 1,
              f"second resume ran epochs {t3.current_epoch}, history {history3}")
        check(not cache.whole_dataset_resident and cache.num_slots < t3.n_train,
              f"{cache.num_slots} slots for {t3.n_train} cases: no refills needed")
        check(cache.slots_refilled >= 1, "the case cache applied no staged slot")
        check_cache_slots(cache)
        e = t3.epoch_timings[-1]
        print(f"[trainer] resumed at epoch {e['epoch']}, case cache of {cache.num_slots} slots "
              f"for {t3.n_train} cases ({REFILL_CACHE_MB} MB): {cache.slots_refilled} slots "
              f"refilled in {REFILL_ITERS} steps (one every {cache._refill_every}), every slot "
              f"holds its case; {e['total']:.3f} s (train {e['train']:.3f} s, fetch-wait "
              f"{e['fetch_wait']:.3f} s, val {e['val']:.3f} s); losses {history3}; peak memory "
              f"{peak3 / 2**30:.2f} GiB; launches {launches3}")
        shutil.copy(os.path.join(t3.output_folder, "checkpoint_final.pt"), keep)
    return {k: launches[k] + launches2[k] + launches3[k] for k in COUNT_KEYS}


def plain_unet_plans():
    """nnU-Net's 3d_fullres PlainConvUNet plans as the JAX planner writes them
    (`planning/planner.py`: base 32 features, at most 320, 2 convs a stage,
    the planner's resampling functions and kwargs) for BraTS: 4 MR channels
    z-scored inside the nonzero mask, 1 mm spacing, patch 128^3, 6 stages."""
    kw_data = {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None}
    kw_seg = {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None}
    fg = {"mean": 400.0, "std": 100.0, "percentile_00_5": 150.0, "percentile_99_5": 700.0}
    return {
        "dataset_name": FILES_DATASET, "plans_name": "ATKPlans",
        "original_median_spacing_after_transp": [1.0, 1.0, 1.0],
        "original_median_shape_after_transp": [140, 190, 160],
        "image_reader_writer": "NiftiIO", "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2], "experiment_planner_used": "ExperimentPlanner",
        "label_manager": "LabelManager",
        "foreground_intensity_properties_per_channel": {str(c): fg for c in range(PLAIN_IN)},
        "configurations": {"3d_fullres": {
            "data_identifier": "ATKPlans_3d_fullres", "preprocessor_name": "DefaultPreprocessor",
            "batch_size": 2, "patch_size": list(PATCH), "median_image_size_in_voxels": [140, 190, 160],
            "spacing": [1.0, 1.0, 1.0], "normalization_schemes": ["ZScoreNormalization"] * PLAIN_IN,
            "use_mask_for_norm": [True] * PLAIN_IN, "UNet_class_name": "PlainConvUNet",
            "UNet_base_num_features": 32, "unet_max_num_features": 320,
            "n_conv_per_stage_encoder": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
            "num_pool_per_axis": [5, 5, 5],
            "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 5,
            "conv_kernel_sizes": [[3, 3, 3]] * 6,
            "resampling_fn_data": "resample_data_or_seg_to_shape",
            "resampling_fn_seg": "resample_data_or_seg_to_shape",
            "resampling_fn_probabilities": "resample_data_or_seg_to_shape",
            "resampling_fn_data_kwargs": kw_data, "resampling_fn_seg_kwargs": kw_seg,
            "resampling_fn_probabilities_kwargs": dict(kw_data, order=1), "batch_dice": True}}}


def write_model_folder(folder):
    """A trained-model folder in the JAX package's layout, written with the
    port's own code: plans.json, dataset.json and fold_0/checkpoint_final.npz
    with a PlainConvUNet's weights from seed 0."""
    os.makedirs(os.path.join(folder, "fold_0"))
    plans = plain_unet_plans()
    dataset_json = {"channel_names": {"0": "T1", "1": "T1ce", "2": "T2", "3": "FLAIR"},
                    "labels": {"background": 0, "NCR": 1, "ED": 2, "ET": 3},
                    "numTraining": 0, "file_ending": ".nii.gz"}
    save_json(plans, os.path.join(folder, "plans.json"))
    save_json(dataset_json, os.path.join(folder, "dataset.json"))
    pm = PlansManager(plans)
    net = build_network_from_plans(pm, pm.get_configuration("3d_fullres"), PLAIN_IN,
                                   PLAIN_CLASSES, deep_supervision=False, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
    tree = state_dict_to_jax("PlainConvUNet", net.state_dict())
    back = plain_unet_state_dict_from_jax(tree)
    check(back.keys() == net.state_dict().keys()
          and all(torch.equal(back[k], v) for k, v in net.state_dict().items()),
          "the JAX-layout weights do not convert back to the network's")
    save_checkpoint(os.path.join(folder, "fold_0", "checkpoint_final.npz"),
                    {"network_weights": tree},
                    {"configuration_name": "3d_fullres", "network_arch_name": "PlainConvUNet",
                     "inference_allowed_mirroring_axes": [0, 1, 2]})
    return sum(v.numel() for v in back.values())


def write_raw_cases(folder):
    """RAW_CASES as BraTS-sized raw cases: 4 int16 channel files of
    240x240x155 each, a bright ellipsoid of BRAIN_MM semi-axes (a smooth
    ramp plus noise, other on each channel) in zeros, so that crop_to_nonzero
    acts."""
    os.makedirs(folder)
    rs = np.random.default_rng(1)
    jobs = []
    for i, (case, spacing) in enumerate(RAW_CASES):
        centre = [n / 2 + 4 * (i - 1) for n in RAW_SHAPE]
        axes = np.ogrid[tuple(slice(0, n) for n in RAW_SHAPE)]
        inside = sum(((a - c) * sp / r) ** 2 for a, c, sp, r in
                     zip(axes, centre, spacing, BRAIN_MM)) <= 1.0
        ramp = (axes[0] + axes[1] + axes[2]).astype(np.int16)
        for c in range(PLAIN_IN):
            vol = 250 + 50 * c + ramp + rs.integers(0, 64, RAW_SHAPE, dtype=np.int16)
            jobs.append((os.path.join(folder, f"{case}_{c:04d}.nii.gz"),
                         np.where(inside, vol, 0).astype(np.int16), spacing))
    with ThreadPoolExecutor(8) as pool:  # gzip releases the GIL
        list(pool.map(lambda j: write_nifti(j[0], j[1], spacing_xyz=j[2]), jobs))


def tiles_of(shape):
    """Sliding-window tiles of a preprocessed (c, x, y, z) volume."""
    padded = [max(int(n), t) for n, t in zip(shape[1:], PATCH)]
    return math.prod(len(s) for s in compute_steps_for_sliding_window(padded, PATCH, 0.5))


def files_phase(root):
    """Prediction from raw files at full PlainConvUNet width: the folder and
    the cases written, initialize_from_trained_model_folder, then
    predict_from_files with 2 spawned preprocessing workers, bf16, 8-flip
    TTA, tile batch 1 (the first case a warm-up). Checks every output's shape,
    geometry and labels, the launches by kernel and variant against the site
    tables (a tile: 7 kernel #1, 10 kernel #2 of which the C = 4 stem simple,
    22 moments), and predict_single_npy_array on the resampled case against
    its file; times the host split in-process of a 1 mm case and of the
    resampled one. Returns the
    launches, the predictor, the resampled case's preprocessed volume and
    the tiles a case."""
    model, raw, out = (os.path.join(root, d) for d in ("model", "raw", "out"))
    t0 = time.perf_counter()
    n_params = write_model_folder(model)
    write_raw_cases(raw)
    print(f"[files] wrote the model folder ({n_params} parameters) and {len(RAW_CASES)} raw "
          f"cases of {PLAIN_IN} x {RAW_SHAPE} int16 .nii.gz in {time.perf_counter() - t0:.1f} s")
    predictor = Predictor(tile_step_size=0.5, use_mirroring=True, tile_batch_size=1,
                          dtype=torch.bfloat16, device="cuda")
    predictor.initialize_from_trained_model_folder(model)
    check(type(predictor.network).__name__ == "PlainConvUNet",
          f"built {type(predictor.network).__name__}")
    per_case = []
    predict = predictor.predict_sliding_window_return_logits

    def recording(data):  # the preprocessed shape, tiles and launches of each case
        before = counts()
        logits = predict(data)
        per_case.append((data.shape, tiles_of(data.shape), since(before)))
        return logits

    predictor.predict_sliding_window_return_logits = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # counts from here on belong to the file path
    zero_counts()
    t0 = time.perf_counter()
    written = predictor.predict_from_files(raw, out, num_processes_preprocessing=2,
                                           num_processes_segmentation_export=2)
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    del predictor.predict_sliding_window_return_logits
    check(written == [os.path.join(out, case) for case, _ in RAW_CASES], f"wrote {written}")
    want = dict.fromkeys(COUNT_KEYS, 0)
    for (case, spacing), (shape, tiles, n), timing in zip(RAW_CASES, per_case,
                                                          predictor.case_timings):
        want_case = {k: tiles * v for k, v in PLAIN_TILE_LAUNCHES.items()}
        check(n == want_case, f"{case}: launches {n}, expected {want_case}")
        want = {k: want[k] + want_case[k] for k in COUNT_KEYS}
        seg, hdr = read_nifti(os.path.join(out, case + ".nii.gz"))
        _, raw_hdr = read_nifti(os.path.join(raw, f"{case}_0000.nii.gz"))
        labels = np.unique(seg)
        check(seg.shape == RAW_SHAPE, f"{case}: segmentation {seg.shape}")
        check(np.allclose(hdr["pixdim"][1:4], spacing)
              and np.array_equal(hdr["affine"], raw_hdr["affine"]),
              f"{case}: spacing {hdr['pixdim'][1:4]}, affine {hdr['affine']}")
        check(set(labels.tolist()) <= set(range(PLAIN_CLASSES)), f"{case}: labels {labels}")
        print(f"[files] {case} at {spacing} mm: preprocessed {tuple(shape)}, {tiles} tiles, "
              f"fetch-wait {timing['fetch_wait']:.3f} s, sliding window "
              f"{timing['sliding_window']:.3f} s, export {timing['export']:.3f} s; labels "
              f"{dict(zip(*np.unique(seg, return_counts=True)))}; launches {n}")
    check(launches == want, f"file path launches {launches}, expected {want}")
    steady = predictor.case_timings[1:]
    case_s = statistics.median(t["fetch_wait"] + t["sliding_window"] for t in steady)
    tiles = statistics.median(t for _, t, _ in per_case)
    print(f"[files] {len(RAW_CASES)} cases in {wall:.3f} s; {case_s:.3f} s a case on the main "
          f"thread (median of {len(steady)} after the warm-up: fetch-wait + sliding window; "
          f"export runs in its threads), {tiles} tiles a case; peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes); launches {launches}")

    # the host split in-process, one case at 1 mm and the resampled one: read,
    # preprocess, sliding window, logits to segmentation, write
    cm = predictor.configuration_manager
    for case, spacing in RAW_CASES[1:]:
        t0 = time.perf_counter()
        image, props = NiftiIO().read_images(
            [os.path.join(raw, f"{case}_{c:04d}.nii.gz") for c in range(PLAIN_IN)])
        t1 = time.perf_counter()
        pp_props = dict(props)
        data, _ = cm.preprocessor_class().run_case_npy(image, None, pp_props,
                                                       predictor.plans_manager, cm,
                                                       predictor.dataset_json)
        t2 = time.perf_counter()
        logits = predictor.predict_sliding_window_return_logits(data)
        t3 = time.perf_counter()
        seg = convert_predicted_logits_to_segmentation_with_correct_shape(
            logits, predictor.plans_manager, cm, predictor.label_manager, pp_props)
        t4 = time.perf_counter()
        NiftiIO().write_seg(seg, os.path.join(root, case + ".nii.gz"), pp_props)
        t5 = time.perf_counter()
        print(f"[files] {case} at {spacing} mm in-process: read {t1 - t0:.3f} s, preprocess "
              f"(crop, normalize{', fp64 resampling' if spacing[2] != 1.0 else ''}) "
              f"{t2 - t1:.3f} s, sliding window {t3 - t2:.3f} s, logits to segmentation"
              f"{' (fp64 resampling back)' if spacing[2] != 1.0 else ''} {t4 - t3:.3f} s, "
              f"write (gzip) {t5 - t4:.3f} s")
    single = predictor.predict_single_npy_array(image, props)
    from_file = NiftiIO().read_seg(os.path.join(out, case + ".nii.gz"))[0][0]
    check(np.array_equal(single, from_file), f"{case}: predict_single_npy_array differs from "
          f"its file on {int((single != from_file).sum())} voxels")
    print(f"[files] {case}: predict_single_npy_array equals its file")
    return launches, predictor, data, tiles


def ladder_phase(predictor, data):
    """The out-of-memory ladder on the card: one volume at tile batch 1 and 2
    uncapped (peak reserved memory of each), then at tile batch 2 under a
    torch.cuda.set_per_process_memory_fraction cap half way between the two
    peaks, where tile batch 2 runs out and 1 fits. Checks that the
    device-resident path ran out at 2 and finished at 1, and that the logits
    match the uncapped tile batch 1 run's within 1e-3 relative."""
    calls = []
    resident = pred_mod.sliding_window_predict_device_resident

    def recording(*args, tile_batch_size, **kw):
        try:
            out = resident(*args, tile_batch_size=tile_batch_size, **kw)
        except RuntimeError as e:
            calls.append((tile_batch_size, "out of memory" if is_oom_error(e) else repr(e)))
            raise
        calls.append((tile_batch_size, "ok"))
        return out

    pred_mod.sliding_window_predict_device_resident = recording
    try:
        peaks, logits = {}, {}
        for tb in (1, 2):
            predictor.tile_batch_size = tb
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            logits[tb] = predictor.predict_sliding_window_return_logits(data)
            peaks[tb] = torch.cuda.max_memory_reserved()
        check(calls == [(1, "ok"), (2, "ok")], f"uncapped calls {calls}")
        check(peaks[2] >= 1.2 * peaks[1], f"peak reserved memory {peaks}: no room for a cap")
        cap = (peaks[1] + peaks[2]) // 2
        total = torch.cuda.get_device_properties(0).total_memory
        calls.clear()
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(cap / total)
        try:
            capped = predictor.predict_sliding_window_return_logits(data)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
    finally:
        pred_mod.sliding_window_predict_device_resident = resident
        predictor.tile_batch_size = 1
    check(calls == [(2, "out of memory"), (1, "ok")], f"capped calls {calls}")
    err = float(np.abs(capped - logits[1]).max() / np.abs(logits[1]).max())
    check(math.isfinite(err) and err <= 1e-3, f"capped logits vs tile batch 1: rel err {err}")
    print(f"[ladder] peak reserved memory: tile batch 1 {peaks[1] / 2**30:.2f} GiB, 2 "
          f"{peaks[2] / 2**30:.2f} GiB; cap {cap / 2**30:.2f} GiB: device-resident calls "
          f"{calls}; logits vs uncapped tile batch 1: rel err {err:.3e}")


def gate_path(label, sites, norms, batch, gen, errs, checked, timed, stem="enc0.0.conv1",
              dx=True):
    """Every launch shape of one path at `batch` against the plain versions,
    with the gates above: kernel #1's forward where it runs it (below
    MIN_VOLUME output voxels) and, with `dx`, its dx at every site but
    `stem`; kernel #2's per-tap forward, with dx through conv3d_zconcat; the
    moments of every norm, square_in_dtype with and without. With `timed`, the times of
    each shape as the phases above take them; else a shape checked before is
    skipped. Updates errs (per kernel [max abs, max rel]) and checked (the
    shapes in LaunchShapes' form); returns the times by kernel and shape."""
    t = {"conv3x3": {}, "zslab": {}, "moments": {}}

    def note(kernel, a, r):
        errs[kernel] = [max(errs[kernel][0], a), max(errs[kernel][1], r)]

    for name, C, F, vol in sites:
        keys = [] if per_tap(vol) else [(C, F, vol)]
        back = dx and name != stem
        if back:
            keys.append((F, C, vol))  # dx: kernel #1 on the flipped weight
        for key in keys:
            shape = (batch, *key[2], key[0], key[1])
            if key in t["conv3x3"] or (not timed and shape in checked["conv3x3"]):
                continue
            times, (a, r), variant = time_site(*key, gen, batch, timed=timed)
            t["conv3x3"][key] = times
            note("conv3x3", a, r)
            checked["conv3x3"].add(shape)
            print(f"[{label}] kernel #1 bf16 B={batch} {key[0]:>4}->{key[1]:<4} @{key[2]}: rel err "
                  f"{r:.3e} ({variant})" + (f"; {times[0]:.3f} ms, plain {times[1]:.3f} ms, "
                                           f"F.conv3d {times[2]:.3f} ms" if times else ""))
            torch.cuda.empty_cache()
        shape = (batch, *vol, C, F)
        if per_tap(vol) and (C, F, vol) not in t["zslab"] and (
                timed or shape not in checked["zslab"]):
            a, r, shares, once, variant, times = zconcat_site(C, F, vol, batch, gen, dx=back,
                                                              timed=timed)
            t["zslab"][(C, F, vol)] = times
            note("zslab", a, r)
            checked["zslab"].add(shape)
            print(f"[{label}] kernel #2 B={batch} {C:>4}->{F:<4} @{vol} ({variant}): rel err "
                  f"{r:.3e}, bit-equal to plain {[round(v, 6) for v in shares]}, kernel #1 fwd "
                  f"{once:.6f}" + (f"; fwd {times[0]:.3f} ms, plain {times[1]:.3f} ms, "
                                   f"F.conv3d {times[2]:.3f} ms" if times else ""))
    for _, vol, C, masked in norms:
        shape = (batch, *vol, C, masked, True)
        if (vol, C, masked) in t["moments"] or (not timed and shape in checked["moments"]):
            continue
        x, mask = moments_inputs(batch, vol, C, masked, torch.bfloat16, gen)
        for square in (False, True):
            a, r = moments_err(x, mask, square)
            check(math.isfinite(r) and r <= 1e-5,
                  f"moments B={batch} {vol} C={C} masked={masked} square_in_dtype={square}: "
                  f"rel error {r}")
            note("moments", a, r)
        line = ""
        if timed:
            visible = int(mask.sum()) if masked else batch * math.prod(vol)
            t["moments"][(vol, C, masked)] = (
                time_ms(lambda: row_moments_forward(x, mask, True), 20),
                time_ms(lambda: row_moments_plain(x, mask, True), 3),
                time_ms(lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0), 5), visible)
            line = (f"; call {t['moments'][(vol, C, masked)][0]:.4f} ms, plain "
                    f"{t['moments'][(vol, C, masked)][1]:.4f} ms, var_mean "
                    f"{t['moments'][(vol, C, masked)][2]:.4f} ms")
        else:
            t["moments"][(vol, C, masked)] = None
        checked["moments"].add(shape)
        print(f"[{label}] moments bf16 B={batch} {vol} C={C} {'masked' if masked else 'plain'}: "
              f"rel err {r:.3e}, two calls bit-equal{line}")
        del x, mask
        torch.cuda.empty_cache()
    return t


def step_totals(t, sites, norms, batch, forwards, dx):
    """Per kernel, the TOTAL_KEYS totals of one step from gate_path's times:
    forwards(name) forwards of each site and norm, dx(name) dx of each site."""
    tot = {k: dict.fromkeys(TOTAL_KEYS, 0.0) for k in t}
    for name, C, F, vol in sites:
        kernel = "zslab" if per_tap(vol) else "conv3x3"
        add_totals(tot[kernel], forwards(name), *t[kernel][(C, F, vol)],
                   *bound_ms(C, F, vol, batch))
        if dx(name):
            add_totals(tot["conv3x3"], dx(name), *t["conv3x3"][(F, C, vol)],
                       *bound_ms(F, C, vol, batch))
    for name, vol, C, masked in norms:
        ms, plain, lib, visible = t["moments"][(vol, C, masked)]
        add_totals(tot["moments"], forwards(name), ms, plain, lib,
                   *moments_bound_ms(batch, vol, C, masked, visible))
    return tot


def print_totals(label, what, tot):
    print(f"[{label}] {what}: " + "; ".join(
        f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f}, plain {v['plain_ms']:.3f}, library "
        f"{v['library_ms']:.3f})" for k, v in tot.items()))


def supervised_gate_phase(gen):
    """Every launch shape that the supervised paths add, against the plain
    versions with the gates of the phases above (gate_path): the STUNet-B
    finetuning step and the ATKTrainer PlainConvUNet step at B = 2, timed
    there; the final validation's forwards at B = 16, checked only. Returns
    per kernel (max abs err, max rel err), the totals of one STUNet-B step
    and of one PlainConvUNet step at B = 2, and the launch shapes checked,
    each in LaunchShapes' form."""
    errs = {k: [0.0, 0.0] for k in ("conv3x3", "zslab", "moments")}
    checked = {k: set() for k in errs}
    steps = {}
    for label, sites, norms, stem in (("STUNet-B", INFER_SITES, INFER_NORMS, "enc0.conv1"),
                                      ("PlainConvUNet", PLAIN_INFER_SITES, PLAIN_INFER_NORMS,
                                       "enc0.conv0")):
        t = gate_path("supervised", sites, norms, SUP_BATCH, gen, errs, checked, True, stem)
        steps[label] = step_totals(t, sites, norms, SUP_BATCH, lambda n: 1,
                                   lambda n, stem=stem: int(n != stem))
        print_totals("supervised", f"one {label} training step at B={SUP_BATCH}", steps[label])
    gate_path("supervised", INFER_SITES, INFER_NORMS, VAL_TTA_BATCH, gen, errs, checked, False,
              dx=False)
    return errs, steps["STUNet-B"], steps["PlainConvUNet"], checked


def write_supervised_dataset(root):
    """A preprocessed dataset as the preprocessor leaves it, written with the
    port's own code: SUP_CASES cases of 1 x 160^3 fp32 (noise, a sphere
    brighter by 2 labelled 1 and one brighter by 4 labelled 2) with the
    properties the sampler and the export read, gt_segmentations as .nii.gz,
    dataset.json, and ATKPlans.json: the files phase's 3d_fullres plans
    (patch 128^3, batch 2, 6 stages) for one CT channel. Returns the plans
    file and dataset.json."""
    base = os.path.join(root, "preprocessed", SUP_DATASET)
    folder, gt = os.path.join(base, "ATKPlans_3d_fullres"), os.path.join(base, "gt_segmentations")
    os.makedirs(folder)
    os.makedirs(gt)
    rs = np.random.default_rng(2)
    axes = np.ogrid[tuple(slice(0, s) for s in SUP_CASE_SHAPE)]
    labels = []
    for i in range(SUP_CASES):
        data = rs.standard_normal((1, *SUP_CASE_SHAPE), dtype=np.float32)
        seg = np.zeros((1, *SUP_CASE_SHAPE), np.int8)
        for label, boost in ((1, 2.0), (2, 4.0)):
            c, r = rs.integers(40, 120, 3), rs.integers(12, 25)
            blob = sum((a - ci) ** 2 for a, ci in zip(axes, c)) < r ** 2
            data[0][blob] += boost
            seg[0][blob] = label
        key = os.path.join(folder, f"case_{i:03d}")
        np.savez(key + ".npz", data=data, seg=seg)
        locs = {}
        for label in (1, 2):
            where = np.argwhere(seg == label)
            locs[label] = where[rs.choice(len(where), min(len(where), 10000), replace=False)]
        n = list(SUP_CASE_SHAPE)
        save_properties({"spacing": [1.0] * 3, "shape_before_cropping": n,
                         "bbox_used_for_cropping": [[0, v] for v in n],
                         "shape_after_cropping_and_before_resampling": n,
                         "class_locations": locs}, key)
        labels.append((seg[0], os.path.join(gt, f"case_{i:03d}.nii.gz")))
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda j: NiftiIO().write_seg(j[0], j[1], {"spacing": [1.0] * 3}),
                      labels))
    dataset_json = {"channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1, "b": 2},
                    "numTraining": SUP_CASES, "file_ending": ".nii.gz"}
    save_json(dataset_json, os.path.join(base, "dataset.json"))
    plans_file = os.path.join(base, "ATKPlans.json")
    save_json(supervised_plans(), plans_file)
    return plans_file, dataset_json


def supervised_plans():
    """The files phase's 3d_fullres plans (patch 128^3, batch 2, 6 stages)
    for one CT channel, z-scored without a mask."""
    plans = plain_unet_plans()
    plans["dataset_name"] = SUP_DATASET
    plans["foreground_intensity_properties_per_channel"] = {
        "0": plans["foreground_intensity_properties_per_channel"]["0"]}
    cfg = plans["configurations"]["3d_fullres"]
    cfg["normalization_schemes"], cfg["use_mask_for_norm"] = ["ZScoreNormalization"], [False]
    return plans


PROFILED_STEPS = 3


def kernel_group(name):
    """A device kernel's group in a step's split: the port's three kernels
    (the conv's PER_TAP instantiations are kernel #2), the library's
    convolutions and matmuls (cuDNN, cuBLAS), the rest by what it does."""
    if "conv3x3_wgmma" in name or "conv3x3_kernel" in name:  # PER_TAP: kernel #2
        return "kernel #2" if "Lb1E" in name or "true>" in name else "kernel #1"
    rules = (("moments", "kernel #3"), ("xmma", "cuDNN/cuBLAS conv and matmul"),
             ("gemm", "cuDNN/cuBLAS conv and matmul"), ("conv", "cuDNN/cuBLAS conv and matmul"),
             ("cutlass", "cuDNN/cuBLAS conv and matmul"), ("index", "gather/scatter (warps)"),
             ("gather", "gather/scatter (warps)"), ("scatter", "gather/scatter (warps)"),
             ("reduce", "reductions"), ("Reduce", "reductions"), ("copy", "copies"),
             ("Copy", "copies"), ("cat", "copies"), ("elementwise", "elementwise"),
             ("Elementwise", "elementwise"), ("foreach", "optimizer (foreach)"),
             ("multi_tensor", "optimizer (foreach)"))
    return next((g for key, g in rules if key in name), "other")


def profile_steps(step, n):
    """torch.profiler over n calls of `step` after a synchronize: device ms a
    call by kernel group, the device's busy ms a call (the sum of its
    kernels), and the host's wall ms a call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    groups = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3 / n
    busy = sum(groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1])
    return (f"wall {wall:.1f} ms a step, device busy {busy:.1f} ms ({busy / wall:.0%}); "
            + ", ".join(f"{g} {ms:.2f}" for g, ms in top))


def sup_run(trainer, **kw):
    """trainer.run_training with the counts at 0, each training step timed
    between two synchronizations; returns the launches, the peak memory and
    the steps' (ms, whether a checkpoint writer thread was running)."""
    step, steps = trainer.train_step, []

    def timed(data, seg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(data, seg)
        torch.cuda.synchronize()
        writer = trainer._ckpt_thread
        steps.append(((time.perf_counter() - t0) * 1e3, writer is not None and writer.is_alive()))
        return loss

    trainer.train_step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    try:
        trainer.run_training(**kw)
    finally:
        del trainer.train_step
    return counts(), torch.cuda.max_memory_allocated(), steps


def print_epochs(trainer, label, steps):
    per_epoch = len(steps) // len(trainer.epoch_timings)
    for i, e in enumerate(trainer.epoch_timings):
        mine = steps[i * per_epoch:(i + 1) * per_epoch]
        print(f"[supervised] {label} epoch {e['epoch']}: {e['total']:.3f} s (train "
              f"{e['train']:.3f} s, fetch-wait {e['fetch_wait']:.3f} s, val {e['val']:.3f} s, "
              f"checkpoint {e['ckpt']:.3f} s); steps "
              f"{[round(ms, 1) for ms, _ in mine]} ms, a checkpoint writer running during "
              f"{sum(w for _, w in mine)} of them")


def supervised_phase(root, pretrain_checkpoint):
    """STUNetTrainer_base_ft at full STUNet-B width (patch 128^3 from a 205^3
    initial patch, batch 2, bf16, 5 deep-supervision heads, AdamW + cosine,
    the default augmentation) on write_supervised_dataset's cases: the
    encoder transfer from `pretrain_checkpoint` (the PretrainTrainer's),
    run_training for 2 epochs x 5 iterations + 2 validation iterations through
    the GPU case cache, a resume for one epoch through the host pipeline,
    perform_actual_validation, checkpoint_final.npz through the Predictor
    against the trainer's network, the bare step, and 3 bare ATKTrainer
    steps of the files phase's PlainConvUNet. Checks the launches by kernel
    and variant of every run. Returns the launches of the supervised runs and
    of the PlainConvUNet steps."""
    plans_file, dataset_json = write_supervised_dataset(root)
    for which in ("preprocessed", "results"):
        os.environ[f"ATK_{which}"] = os.path.join(root, which)
    cfg = replace(get_trainer_config("STUNetTrainer_base_ft"), num_epochs=SUP_EPOCHS,
                  num_iterations_per_epoch=SUP_ITERS, num_val_iterations_per_epoch=SUP_VAL_ITERS,
                  save_every=1)
    out = os.path.join(root, "results", "finetune")

    def trainer(c):
        return Trainer(plans_file, "3d_fullres", 0, dataset_json, c, output_folder=out,
                       device="cuda")

    # 1. the encoder transfer
    t = trainer(cfg)
    t.initialize()
    n_params = sum(p.numel() for p in t.network.parameters())
    before = {k: v.clone() for k, v in t.network.state_dict().items()}
    load_ssl_encoder_into_trainer(t, pretrain_checkpoint, verbose=False)
    encoder = load_trainer_checkpoint(pretrain_checkpoint)[0]["network_weights"]
    moved = 0
    for k, v in t.network.state_dict().items():
        src = encoder.get(f"sparse_encoder.sp_cnn.{k}")
        if src is not None:
            check(torch.equal(v.cpu(), src), f"transfer: {k} is not the pretrained encoder's")
            moved += 1
        else:
            check(torch.equal(v, before[k]), f"transfer: {k} moved")
    n_enc = sum(k.startswith("sparse_encoder.sp_cnn.conv_blocks_context.") for k in encoder)
    check(moved == n_enc > 0, f"transfer: {moved} tensors of {n_enc} encoder tensors")
    print(f"[supervised] STUNet-B, {n_params} parameters, 5 heads; the pretrained encoder's "
          f"{moved} tensors (stages 0-4) transferred, the 6th stage, decoder and heads as "
          f"initialised")
    del before

    # 2. training through the case cache, then a resume through the host pipeline
    launches, peak, steps = sup_run(t)
    lg = t.logger.logging
    check(all(math.isfinite(v) for k in ("train_losses", "val_losses") for v in lg[k])
          and all(math.isfinite(d) for ds in lg["dice_per_class_or_region"] for d in ds),
          f"non-finite losses or Dice {lg}")
    cache = t.device_cache_train
    check(cache is not None and cache.whole_dataset_resident,
          "the training cases are not all resident in the case cache")
    want = {k: SUP_EPOCHS * (SUP_ITERS * SUP_STEP_LAUNCHES[k] + SUP_VAL_ITERS
                             * SUP_VAL_LAUNCHES[k]) for k in COUNT_KEYS}
    check(launches == want, f"finetuning launches {launches}, expected {want}")
    for f in ("checkpoint_best.npz", "checkpoint_final.npz", "debug.json", "../plans.json"):
        check(os.path.isfile(os.path.join(t.output_folder, f)), f"no {f}")
    print(f"[supervised] patch {tuple(t.configuration_manager.patch_size)} from initial patch "
          f"{t.initial_patch_size}, batch {SUP_BATCH}, bf16, {len(t.do_split()[0])} training "
          f"cases in {cache.num_slots} cache slots of {cache.slot_shape}; train losses "
          f"{lg['train_losses']}, val losses {lg['val_losses']}, pseudo-Dice "
          f"{lg['dice_per_class_or_region']}; peak memory {peak / 2**30:.2f} GiB ({peak} "
          f"bytes); launches {launches}")
    print_epochs(t, "cache", steps)
    last = t.epoch_timings[-1]
    trainer_step_ms = last["train"] / SUP_ITERS * 1e3
    timed_ms = statistics.median(ms for ms, _ in steps[SUP_ITERS:])
    shutil.copy(os.path.join(t.output_folder, "checkpoint_final.npz"),
                os.path.join(t.output_folder, "checkpoint_latest.npz"))
    t2 = trainer(replace(cfg, num_epochs=SUP_EPOCHS + 1, device_cache=False))
    launches2, peak2, steps2 = sup_run(t2, continue_training=True)
    check(t2.current_epoch == SUP_EPOCHS and [e["epoch"] for e in t2.epoch_timings] == [SUP_EPOCHS]
          and t2.step_counter == (SUP_EPOCHS + 1) * SUP_ITERS,
          f"resume ran epochs {[e['epoch'] for e in t2.epoch_timings]}, step {t2.step_counter}")
    want2 = {k: SUP_ITERS * SUP_STEP_LAUNCHES[k] + SUP_VAL_ITERS * SUP_VAL_LAUNCHES[k]
             for k in COUNT_KEYS}
    check(launches2 == want2, f"resume launches {launches2}, expected {want2}")
    check(all(math.isfinite(v) for v in t2.logger.logging["train_losses"]), "resume: loss")
    print_epochs(t2, "host pipeline (resumed)", steps2)
    print(f"[supervised] resumed at epoch {SUP_EPOCHS} from checkpoint_latest; peak memory "
          f"{peak2 / 2**30:.2f} GiB; launches {launches2}")

    # 3. the final validation
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    metrics = t2.perform_actual_validation()
    val_s = time.perf_counter() - t0
    launches3 = counts()
    _, val_keys = t2.do_split()
    ds_val = CaseDataset(t2.preprocessed_dataset_folder, val_keys)
    forwards = sum(math.ceil(tiles_of(ds_val.case_shape(k)) / 2) for k in val_keys)
    want3 = {k: forwards * SUP_VAL_LAUNCHES[k] for k in COUNT_KEYS}
    check(launches3 == want3, f"final validation launches {launches3}, expected {want3}")
    summary = os.path.join(t2.output_folder, "validation", "summary.json")
    check(os.path.isfile(summary), "no summary.json")
    dice = {k: v["Dice"] for k, v in metrics["mean"].items()}
    check(set(dice) == {1, 2} and all(math.isfinite(v) for v in dice.values()),
          f"final validation Dice {dice}")
    print(f"[supervised] final validation of {len(val_keys)} cases ({forwards} forwards of "
          f"B={VAL_TTA_BATCH}): {val_s:.3f} s, mean Dice per class {dice}; launches {launches3}")

    # 4. checkpoint_final.npz through the Predictor against the trainer's network
    case = np.asarray(ds_val.load_case(val_keys[0])[0])
    p1 = Predictor(tile_batch_size=1, dtype=torch.bfloat16, device="cuda")
    p1.initialize_from_trained_model_folder(t2.output_folder_base, use_folds=[0])
    p2 = Predictor(tile_batch_size=1, dtype=torch.bfloat16, device="cuda")
    p2.manual_initialization(t2._build_network(False), t2.plans_manager, t2.configuration_manager,
                             [t2.network.state_dict()], dataset_json,
                             t2.inference_allowed_mirroring_axes)
    zero_counts()
    a, b = (p.predict_sliding_window_return_logits(case) for p in (p1, p2))
    launches4 = counts()
    err = float(np.abs(a - b).max() / np.abs(b).max())
    check(np.isfinite(a).all() and a.shape == (3, *SUP_CASE_SHAPE) and err <= 1e-3,
          f"checkpoint_final.npz through the Predictor: shape {a.shape}, rel err {err}")
    print(f"[supervised] checkpoint_final.npz through the Predictor vs the trainer's network "
          f"(tile batch 1): rel err {err:.3e}")
    del p1, p2, a, b

    # 5. the bare step and validation step on a batch from the case cache
    data, seg = cache.extract_split(*cache.sample_batch())
    vdata, vseg = t.device_cache_val.extract_split(*t.device_cache_val.sample_batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for step in range(STEPS):
        before_n = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(t.train_step(data, seg).item())
        times.append((time.perf_counter() - t0) * 1e3)
        n = since(before_n)
        check(math.isfinite(losses[-1]) and n == SUP_STEP_LAUNCHES,
              f"bare step {step}: loss {losses[-1]}, launches {n}, expected {SUP_STEP_LAUNCHES}")
    split = profile_steps(lambda: t.train_step(data, seg), PROFILED_STEPS)
    before_n = counts()
    loss, tp, fp, fn_ = t.val_step(vdata, vseg)
    check(math.isfinite(loss.item()), f"val step loss {loss.item()}")
    n_val = since(before_n)
    check(n_val == SUP_VAL_LAUNCHES, f"val step launches {n_val}, expected {SUP_VAL_LAUNCHES}")
    launches5 = counts()
    step_ms = statistics.median(times[WARMUP:])
    peak5 = torch.cuda.max_memory_allocated()
    print(f"[supervised] bare step {step_ms:.1f} ms (median of steps {WARMUP + 1}-{STEPS}: "
          f"{[round(v, 1) for v in times]}), {SUP_BATCH / step_ms * 1e3:.3f} patches/s; step "
          f"through the trainer {trainer_step_ms:.1f} ms (epoch {last['epoch']}: {last['train']:.3f} "
          f"s for {SUP_ITERS} steps; the median step of that epoch between two "
          f"synchronizations {timed_ms:.1f} ms); peak memory {peak5 / 2**30:.2f} GiB ({peak5} bytes); "
          f"launches a training step {SUP_STEP_LAUNCHES}, a validation step {n_val}; losses "
          f"{losses}")
    print(f"[supervised] where a bare step's time goes (torch.profiler, {PROFILED_STEPS} steps): "
          f"{split}")
    del t, t2, cache, data, seg, vdata, vseg
    free_memory()

    # 6. ATKTrainer steps of the files phase's PlainConvUNet (SGD, poly, bf16)
    tp_ = Trainer(plain_unet_plans(), "3d_fullres", 0,
                  {"channel_names": {str(c): f"MR{c}" for c in range(PLAIN_IN)},
                   "labels": {"background": 0, "a": 1, "b": 2, "c": 3}, "file_ending": ".nii.gz"},
                  get_trainer_config("ATKTrainer"), output_folder=os.path.join(root, "atk"),
                  preprocessed_dataset_folder_base=os.path.join(root, "atk_pp"), device="cuda")
    tp_.initialize()
    gen = torch.Generator(device="cuda").manual_seed(3)
    data = torch.randn((SUP_BATCH, *tp_.initial_patch_size, PLAIN_IN), generator=gen,
                       device="cuda")
    seg = torch.randint(0, PLAIN_CLASSES, (SUP_BATCH, *tp_.initial_patch_size, 1), generator=gen,
                        device="cuda").to(torch.int16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for step in range(PLAIN_STEPS):
        before_n = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = tp_.train_step(data, seg).item()
        times.append((time.perf_counter() - t0) * 1e3)
        n = since(before_n)
        check(math.isfinite(loss) and n == PLAIN_STEP_LAUNCHES,
              f"ATKTrainer step {step}: loss {loss}, launches {n}, expected {PLAIN_STEP_LAUNCHES}")
    plain_launches = counts()
    peak6 = torch.cuda.max_memory_allocated()
    print(f"[supervised] ATKTrainer PlainConvUNet ({PLAIN_IN} channels, {PLAIN_CLASSES} labels, "
          f"patch 128^3 from {tp_.initial_patch_size}, batch {SUP_BATCH}, bf16, SGD): steps "
          f"{[round(v, 1) for v in times]} ms, peak memory {peak6 / 2**30:.2f} GiB; launches a "
          f"step {PLAIN_STEP_LAUNCHES}")
    runs = (launches, launches2, launches3, launches4, launches5)
    return {k: sum(r[k] for r in runs) for k in COUNT_KEYS}, plain_launches


def h_gate_phase(gen):
    """Every launch shape of pretrain-H held against the plain versions: the
    H step's at its microbatch (B = 2) and the finetuning step's (B = 2),
    timed; the validation forwards and the grad_accum_steps=1 step at B = 4
    (among them kernel #2 and kernel #1's dx at 192 -> 192 on 112x112x128, a
    1.23e9-element activation), checked only. Returns per kernel (max abs
    err, max rel err), the totals of one H step and of one finetuning step,
    and the launch shapes checked."""
    errs = {k: [0.0, 0.0] for k in ("conv3x3", "zslab", "moments")}
    checked = {k: set() for k in errs}
    t_step = gate_path("pretrain-H", H_SITES, H_NORMS, H_MICRO, gen, errs, checked, True)
    micro = H_CFG.grad_accum_steps
    step = step_totals(t_step, H_SITES, H_NORMS, H_MICRO, lambda n: h_forwards(n, micro),
                       lambda n: 0 if n == "enc0.0.conv1" else micro)
    print_totals("pretrain-H", f"one step (B = {BATCH} in {micro} microbatches of {H_MICRO}, "
                 f"remat)", step)
    gate_path("pretrain-H", H_SITES, H_NORMS, BATCH, gen, errs, checked, False)
    t_sup = gate_path("finetune-H", H_SUP_SITES, H_SUP_NORMS, SUP_BATCH, gen, errs, checked,
                      True)
    sup = step_totals(t_sup, H_SUP_SITES, H_SUP_NORMS, SUP_BATCH, lambda n: 2,
                      lambda n: 0 if n == "enc0.0.conv1" else 1)
    print_totals("finetune-H", f"one STUNetTrainer_huge step (B = {SUP_BATCH}, remat)", sup)
    return errs, step, sup, checked


def h_step_phase():
    """The AnatoMask step at STUNet-H, as atk_pretrain -model H runs it: 2
    warm-up and 3 timed steps, checking finite losses, the hard masks and
    the launches by kernel and variant (h_step_launches: per microbatch the
    teacher's forward, the student's and remat's second one, dx); then a
    torch.profiler split of H_PROFILED steps, one step at grad_accum_steps=1
    (B = 4) and one LAMB step, each finite, with their own launches.
    Returns the phase's launches and the median step ms."""
    cfg = H_CFG
    student = build_spark_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    teacher = make_teacher(student)
    optimizer = make_optimizer(student, cfg)
    micro = accumulation_steps(BATCH, cfg.grad_accum_steps)
    check(micro == 2 and student.fmap == FMAP and student.len_keep == LEN_KEEP,
          f"H sizes: micro {micro}, fmap {student.fmap}, keep {student.len_keep}")
    check(student.sparse_encoder.sp_cnn.remat and student.dense_decoder.remat,
          "STUNet-H pretraining runs without remat")
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand((BATCH, 1, *cfg.patch_size), generator=gen, device="cuda")
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    L = math.prod(student.fmap)
    len_loss = int((L - student.len_keep) * 0.25)
    n_params = sum(p.numel() for p in student.parameters())
    print(f"[pretrain-H] STUNet-H SparK, {n_params} parameters (dims {H_DIMS}, 3 blocks a "
          f"stage, decoder width {student.dense_decoder.width}), patch {cfg.patch_size}, batch "
          f"{BATCH} in {micro} microbatches, mask ratio {cfg.mask_ratio}, {cfg.compute_dtype}, "
          f"{cfg.optimizer}, "
          f"remat; forced {len_loss}")

    def step(opt, accum):
        loss, hard, loss_map = anatomask_train_step(student, teacher, opt, x, len_loss, gen,
                                                    grad_accum_steps=accum)
        return loss.item(), hard, loss_map

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    # counts from here on belong to the H pretraining path
    zero_counts()
    for i in range(H_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, hard, loss_map = step(optimizer, micro)
        times.append((time.perf_counter() - t0) * 1e3)
        n = since(before)
        check(math.isfinite(loss), f"H step {i}: loss {loss}")
        hard = hard.reshape(BATCH, L)
        check(hard.sum(1).tolist() == [student.len_keep] * BATCH, f"H step {i}: kept "
              f"{hard.sum(1).tolist()}")
        top = torch.topk(loss_map, len_loss, dim=1).indices
        check(not torch.gather(hard, 1, top).any(), f"H step {i}: a forced patch is kept")
        check(n == H_STEP_LAUNCHES, f"H step {i}: launches {n}, expected {H_STEP_LAUNCHES}")
        print(f"[pretrain-H] step {i}: loss {loss:.6f}, {times[-1]:.1f} ms, launches {n}")
    step_ms = statistics.median(times[WARMUP:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[pretrain-H] step {step_ms:.1f} ms (median of {H_STEPS - WARMUP}), "
          f"{BATCH / step_ms * 1e3:.3f} patches/s, peak memory {peak / 2**30:.2f} GiB ({peak} "
          f"bytes); launches a step {H_STEP_LAUNCHES}")
    split = profile_steps(lambda: step(optimizer, micro), H_PROFILED)
    print(f"[pretrain-H] where a step's time goes (torch.profiler, {H_PROFILED} steps): {split}")
    torch.cuda.reset_peak_memory_stats()
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_one = step(optimizer, 1)[0]
    one_ms = (time.perf_counter() - t0) * 1e3
    peak_one = torch.cuda.max_memory_allocated()
    n_one = since(before)
    del optimizer
    free_memory()
    lamb = make_optimizer(student, replace(cfg, optimizer="lamb"))
    check(isinstance(lamb, Lamb), f"optimizer lamb built {type(lamb).__name__}")
    loss_lamb = step(lamb, micro)[0]
    launches = counts()
    del lamb
    check(math.isfinite(loss_lamb) and math.isfinite(loss_one),
          f"LAMB step loss {loss_lamb}, grad_accum_steps=1 step loss {loss_one}")
    check(n_one == H_STEP1_LAUNCHES, f"grad_accum_steps=1 launches {n_one}, expected "
          f"{H_STEP1_LAUNCHES}")
    want = {k: (H_STEPS + H_PROFILED + 1) * H_STEP_LAUNCHES[k] + H_STEP1_LAUNCHES[k]
            for k in COUNT_KEYS}
    check(launches == want, f"pretrain-H launches {launches}, expected {want}")
    print(f"[pretrain-H] a step at grad_accum_steps=1 (B = {BATCH} at once): loss "
          f"{loss_one:.6f}, {one_ms:.1f} ms, peak memory {peak_one / 2**30:.2f} GiB, launches "
          f"{n_one}; a LAMB step: loss {loss_lamb:.6f}; launches in the phase {launches}")
    del student, teacher, x
    free_memory()
    return launches, step_ms


def h_trainer_phase(root, bare_step_ms):
    """PretrainTrainer.run_pretraining at STUNet-H (H_CFG) on
    write_trainer_dataset's cases: 1 epoch x 2 iterations with the GPU case
    cache, validation and the checkpoints, then a resumed epoch. Each run
    writes one checkpoint (~16 bytes a parameter: student, teacher, two AdamW
    moments) and links its other names to it; they go to `root`, which the
    caller deletes; the phase first checks that the disk holds three.
    Returns the launches of both runs and the resumed run's
    checkpoint_final.pt."""
    write_trainer_dataset(root)
    for which in ("preprocessed", "results"):
        os.environ[f"ATK_{which}"] = os.path.join(root, which)
    cfg = replace(H_CFG, num_epochs=1, iters_per_epoch=2, device_cache=True)
    out = os.path.join(root, "results", "pretrain_H")
    trainer = PretrainTrainer(TRAINER_DATASET, cfg, device="cuda", output_folder=out)
    need = 3 * 16 * sum(p.numel() for p in trainer.model.parameters())
    free = shutil.disk_usage(root).free
    check(free >= need, f"the disk under {root} has {free / 1e9:.1f} GB free; the STUNet-H "
          f"trainer phase holds up to {need / 1e9:.1f} GB of checkpoints at once")
    writes = []
    save = ckpt_mod.save_trainer_checkpoint

    def timed_save(path, state, meta):  # the writer thread's and the final save's
        t0 = time.perf_counter()
        save(path, state, meta)
        writes.append((os.path.basename(path), time.perf_counter() - t0, os.path.getsize(path)))

    ckpt_mod.save_trainer_checkpoint = timed_save
    try:
        t, history, launches, peak = trainer_run(cfg, trainer=trainer, step=H_STEP_LAUNCHES,
                                                 val=H_VAL_LAUNCHES)
        e = t.epoch_timings[-1]
        print(f"[pretrain-H trainer] {t.n_train} training cases in {t.device_cache.num_slots} "
              f"cache slots; epoch {e['epoch']}: {e['total']:.3f} s (train {e['train']:.3f} s, "
              f"{e['train'] / cfg.iters_per_epoch * 1e3:.1f} ms a step through the trainer (bare "
              f"step {bare_step_ms:.1f} ms), "
              f"fetch-wait {e['fetch_wait']:.3f} s, val {e['val']:.3f} s, checkpoint snapshot "
              f"{e['ckpt']:.3f} s); losses {history}; peak memory {peak / 2**30:.2f} GiB; "
              f"launches {launches}")
        names = ("checkpoint_latest.pt", "H_head_latest.pt", "checkpoint_best.pt",
                 "checkpoint_final.pt")
        for f in names + ("history.json",):
            check(os.path.isfile(os.path.join(out, f)), f"no {f}")
        check(len(writes) == 1 and len({os.stat(os.path.join(out, f)).st_ino for f in names}) == 1,
              f"H checkpoints: wrote {writes}, expected one file under {names}")
        print(f"[pretrain-H trainer] checkpoint written once ({', '.join(names)} one file): "
              + ", ".join(f"{name} {size / 1e9:.3f} GB in {s:.3f} s" for name, s, size in writes))
        del t, trainer
        free_memory()
        writes.clear()
        t0 = time.perf_counter()
        resume = replace(cfg, num_epochs=2)
        t2, history2, launches2, peak2 = trainer_run(resume, True, out, step=H_STEP_LAUNCHES,
                                                     val=H_VAL_LAUNCHES)
        total = time.perf_counter() - t0
    finally:
        ckpt_mod.save_trainer_checkpoint = save
    check(t2.current_epoch == 1 and len(history2["train_loss"]) == 1 and len(writes) == 1
          and t2._optimizer_count() == 4, f"H resume ran epoch {t2.current_epoch}, history "
          f"{history2}, optimizer count {t2._optimizer_count()}, wrote {writes}")
    e = t2.epoch_timings[-1]
    print(f"[pretrain-H trainer] resumed at epoch {e['epoch']} from checkpoint_latest "
          f"({total:.3f} s with the model built and the checkpoint loaded): epoch "
          f"{e['total']:.3f} s (train {e['train']:.3f} s, val {e['val']:.3f} s, snapshot "
          f"{e['ckpt']:.3f} s); losses {history2}; peak memory {peak2 / 2**30:.2f} GiB; "
          f"checkpoints " + ", ".join(f"{name} {size / 1e9:.3f} GB in {s:.3f} s"
                                      for name, s, size in writes))
    del t2
    free_memory()
    return {k: launches[k] + launches2[k] for k in COUNT_KEYS}, os.path.join(
        out, "checkpoint_final.pt")


def h_transfer_phase(root, pretrain_checkpoint):
    """STUNetTrainer_huge (remat, as the JAX preset) on the supervised
    phase's plans: load_ssl_encoder_into_trainer from the H trainer's
    checkpoint_final.pt (every encoder tensor the pretrained one's, the rest
    as initialised), then H_SUP_STEPS bare training steps at 128^3, batch 2,
    on a random batch of the initial patch. Returns the launches."""
    plans = supervised_plans()
    dataset_json = {"channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1, "b": 2},
                    "numTraining": SUP_CASES, "file_ending": ".nii.gz"}
    t = Trainer(plans, "3d_fullres", 0, dataset_json, get_trainer_config("STUNetTrainer_huge"),
                output_folder=os.path.join(root, "finetune_h"),
                preprocessed_dataset_folder_base=os.path.join(root, "pp"), device="cuda")
    t.initialize()
    check(t.network.remat, "STUNetTrainer_huge's STUNet runs without remat")
    n_params = sum(p.numel() for p in t.network.parameters())
    before = {k: v.clone() for k, v in t.network.state_dict().items()}
    t0 = time.perf_counter()
    load_ssl_encoder_into_trainer(t, pretrain_checkpoint, verbose=False)
    load_s = time.perf_counter() - t0
    encoder = load_trainer_checkpoint(pretrain_checkpoint)[0]["network_weights"]
    moved = 0
    for k, v in t.network.state_dict().items():
        src = encoder.get(f"sparse_encoder.sp_cnn.{k}")
        if src is not None:
            check(torch.equal(v.cpu(), src), f"H transfer: {k} is not the pretrained encoder's")
            moved += 1
        else:
            check(torch.equal(v, before[k]), f"H transfer: {k} moved")
    n_enc = sum(k.startswith("sparse_encoder.sp_cnn.conv_blocks_context.") for k in encoder)
    check(moved == n_enc > 0, f"H transfer: {moved} tensors of {n_enc} encoder tensors")
    del before, encoder
    free_memory()
    print(f"[finetune-H] STUNet-H, {n_params} parameters, remat; the pretrained encoder's "
          f"{moved} tensors (stages 0-4, 3 blocks each) transferred in {load_s:.3f} s")
    gen = torch.Generator(device="cuda").manual_seed(12)
    data = torch.randn((SUP_BATCH, *t.initial_patch_size, 1), generator=gen, device="cuda")
    seg = torch.randint(0, 3, (SUP_BATCH, *t.initial_patch_size, 1), generator=gen,
                        device="cuda").to(torch.int16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()  # counts from here on belong to the H finetuning path
    times = []
    for i in range(H_SUP_STEPS):
        before_n = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = t.train_step(data, seg).item()
        times.append((time.perf_counter() - t0) * 1e3)
        n = since(before_n)
        check(math.isfinite(loss) and n == H_SUP_STEP_LAUNCHES,
              f"H finetuning step {i}: loss {loss}, launches {n}, expected {H_SUP_STEP_LAUNCHES}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[finetune-H] patch 128^3 from {t.initial_patch_size}, batch {SUP_BATCH}, bf16: "
          f"steps {[round(v, 1) for v in times]} ms ({SUP_BATCH / times[-1] * 1e3:.3f} "
          f"patches/s at the last), peak memory {peak / 2**30:.2f} GiB ({peak} bytes); "
          f"launches a step {H_SUP_STEP_LAUNCHES}")
    del t, data, seg
    free_memory()
    return launches


def kidney_case(rs, shape, spacing):
    """One KiTS-like CT case at `spacing` (mm, array axes z, y, x): int16 HU,
    air (-1000) around an elliptic soft-tissue body (40 HU), two kidneys
    (180 HU, label 1) and a tumour in the left one (90 HU, label 2), placed
    in mm so that both spacings image the same anatomy; noise 15 HU."""
    ext = [n * sp for n, sp in zip(shape, spacing)]
    z, y, x = np.ogrid[tuple(slice(0, n) for n in shape)]
    z, y, x = z * spacing[0], y * spacing[1], x * spacing[2]
    body = ((y - ext[1] / 2) / (0.45 * ext[1])) ** 2 + ((x - ext[2] / 2) / (0.48 * ext[2])) ** 2 <= 1
    img = np.where(body, 40.0, -1000.0) + rs.normal(0, 15, shape)
    seg = np.zeros(shape, np.uint8)
    zc = ext[0] / 2 + rs.uniform(-10, 10)
    for side in (-1, 1):
        xc, yc = ext[2] / 2 + side * 0.22 * ext[2], 0.6 * ext[1]
        kidney = ((z - zc) / 35) ** 2 + ((y - yc) / 22) ** 2 + ((x - xc) / 18) ** 2 <= 1
        img[kidney], seg[kidney] = 180 + rs.normal(0, 15, int(kidney.sum())), 1
        if side < 0:
            tumour = (z - zc - 12) ** 2 + (y - yc) ** 2 + (x - xc - 6) ** 2 <= 12 ** 2
            img[tumour], seg[tumour] = 90 + rs.normal(0, 15, int(tumour.sum())), 2
    return np.clip(img, -1024, 3071).astype(np.int16), seg


def write_cli_dataset(raw):
    """CLI_DATASET as a user brings it: imagesTr/labelsTr (CLI_TRAIN) and
    imagesTs/labelsTs (CLI_TEST) of kidney_case volumes, written with the
    port's NIfTI writer, and dataset.json with generate_dataset_json."""
    rs = np.random.default_rng(4)
    jobs = []
    for split, cases in (("Tr", CLI_TRAIN), ("Ts", CLI_TEST)):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(raw, f"{sub}{split}"))
        for name, shape, spacing in cases:
            img, seg = kidney_case(rs, shape, spacing)
            jobs += [(os.path.join(raw, f"images{split}", f"{name}_0000.nii.gz"), img, spacing),
                     (os.path.join(raw, f"labels{split}", f"{name}.nii.gz"), seg, spacing)]
    with ThreadPoolExecutor(8) as pool:  # gzip releases the GIL
        list(pool.map(lambda j: write_nifti(j[0], j[1].transpose(2, 1, 0),
                                            spacing_xyz=j[2][::-1]), jobs))
    generate_dataset_json(raw, {0: "CT"}, CLI_LABELS, len(CLI_TRAIN), ".nii.gz",
                          dataset_name=CLI_DATASET)


class StepTimer:
    """While on, ms of every call of owner.name between two synchronizations."""

    def __init__(self, owner, name):
        self.owner, self.name, self.ms = owner, name, []
        self.inner = getattr(owner, name)

    def __enter__(self):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.inner(*args, **kw)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(self.owner, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.inner)


def check_plans(plans):
    """The plans that plan_and_preprocess wrote are what the JAX planner
    plans for CLI_DATASET."""
    configs = plans["configurations"]
    check("3d_lowres" not in configs and "3d_cascade_fullres" not in configs,
          f"configurations {sorted(configs)}")
    c3 = configs["3d_fullres"]
    check({k: c3[k] for k in CLI_3D} == CLI_3D,
          f"3d_fullres {[(k, c3[k]) for k in CLI_3D if c3[k] != CLI_3D[k]]}")
    check(np.allclose(c3["spacing"], (1.5, 0.8, 0.8), rtol=1e-6), f"spacing {c3['spacing']}")
    check({k: configs["2d"][k] for k in CLI_2D} == CLI_2D, f"2d {configs['2d']}")


def cli_gate_phase(gen, checked):
    """Every launch shape that the CLI's entries add, against the plain
    versions with gate_path's gates, before an entry runs them: the planner's
    PlainConvUNet (one input channel) training step at its batch 2, timed;
    its tile forward at CLI_TILE_BATCH, timed; the pretraining step at its
    microbatch (B = 2, forward and dx), checked only. Returns per kernel
    (max abs err, max rel err), the totals of one PlainConvUNet step and of
    one test case and fold (4 forwards of 2 tiles)."""
    errs = {k: [0.0, 0.0] for k in ("conv3x3", "zslab", "moments")}
    sites = plain_sites(1)
    t = gate_path("cli", sites, PLAIN_INFER_NORMS, CLI_3D["batch_size"], gen, errs, checked,
                  True, "enc0.conv0")
    step = step_totals(t, sites, PLAIN_INFER_NORMS, CLI_3D["batch_size"], lambda n: 1,
                       lambda n: int(n != "enc0.conv0"))
    print_totals("cli", f"one planner PlainConvUNet step at B={CLI_3D['batch_size']}", step)
    t = gate_path("cli", sites, PLAIN_INFER_NORMS, CLI_TILE_BATCH, gen, errs, checked, True,
                  dx=False)
    forwards = math.ceil(tiles_of((1, *CLI_TEST[0][1])) / 2)
    case = step_totals(t, sites, PLAIN_INFER_NORMS, CLI_TILE_BATCH, lambda n: forwards,
                       lambda n: 0)
    print_totals("cli", f"one test case and fold ({forwards} forwards at B={CLI_TILE_BATCH})",
                 case)
    gate_path("cli", SITES, PRETRAIN_NORMS, BATCH // 2, gen, errs, checked, False)
    return errs, step, case


def cli_phase(root, gen, checked, shapes):
    """The port's command line from a raw dataset to ensembled, postprocessed
    segmentations, each entry called with its argv as a user types it, under
    ATK_raw/ATK_preprocessed/ATK_results in `root`:
    plan_and_preprocess (--verify_dataset_integrity, 4 spawned workers),
    then cli_gate_phase on the shapes its plans imply; pretrain (atk_pretrain's
    defaults: STUNet-B AnatoMask, 112x112x128, batch 4 in 2 microbatches,
    bf16) for 1 epoch x CLI_PRETRAIN_ITERS; train ATKTrainer_1epoch folds 0
    and 1 --npz and STUNetTrainer_base_ft fold 0 from the pretraining
    checkpoint (its preset cut to one epoch), CLI_ITERS iterations and
    CLI_VAL_ITERS validation iterations an epoch; predict the test cases
    with both models, ensemble, evaluate, find_best_configuration,
    apply_postprocessing, accumulate_crossval_results; export_model,
    install_model into a second results tree, whose fold must predict the
    original's logits; move_plans_between_datasets. Checks each output, and
    that pretrain, train and predict launch all three kernels. `shapes`
    (LaunchShapes) records no launch of the gates. Returns the
    launches of the phase, per kernel (max abs err, max rel err) of its
    gates and their totals of one step and one test case."""
    dirs = {w: os.path.join(root, w) for w in ("raw", "preprocessed", "results")}
    raw = os.path.join(dirs["raw"], CLI_DATASET)
    env = {**{f"ATK_{w}": d for w, d in dirs.items()},
           "ATK_ITERS_PER_EPOCH": str(CLI_ITERS), "ATK_VAL_ITERS": str(CLI_VAL_ITERS)}
    saved_env = {k: os.environ.get(k) for k in env}
    ft = "STUNetTrainer_base_ft"
    preset = trainer_mod.TRAINER_PRESETS[ft]
    os.environ.update(env)
    trainer_mod.TRAINER_PRESETS[ft] = replace(preset, num_epochs=1)
    runs, steps = {}, {}
    start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        write_cli_dataset(raw)
        print(f"[cli] {len(CLI_TRAIN)} training and {len(CLI_TEST)} test cases of {CLI_DATASET} "
              f"written in {time.perf_counter() - t0:.1f} s")

        def run(name, entry, argv, timer=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            if timer is None:
                entry(argv)
            else:
                with timer:
                    entry(argv)
                steps[name] = timer.ms
            torch.cuda.synchronize()
            runs[name] = dict(seconds=time.perf_counter() - t0,
                              peak=torch.cuda.max_memory_allocated(), launches=counts())
            free_memory()
            r = runs[name]
            line = (f"[cli] {name}: {r['seconds']:.3f} s, peak memory {r['peak'] / 2**30:.2f} "
                    f"GiB ({r['peak']} bytes), launches {r['launches']}")
            if name in steps:
                ms = steps[name]
                line += (f"; {len(ms)} steps, median {statistics.median(ms):.1f} ms "
                         f"({[round(v, 1) for v in ms]})")
            print(line)
            return r

        run("plan_and_preprocess", cli.plan_and_preprocess_entry,
            ["-d", str(CLI_ID), "-c", "3d_fullres", "--verify_dataset_integrity", "-np", "4"])
        pp = os.path.join(dirs["preprocessed"], CLI_DATASET)
        plans = load_json(os.path.join(pp, "ATKPlans.json"))
        check_plans(plans)
        data_dir = os.path.join(pp, plans["configurations"]["3d_fullres"]["data_identifier"])
        pp_shapes = {}
        for name, *_ in CLI_TRAIN:
            with np.load(os.path.join(data_dir, name + ".npz")) as z:
                pp_shapes[name] = z["data"].shape
            check(os.path.isfile(os.path.join(data_dir, name + ".props.json")),
                  f"{name}: no properties")
        check(set(pp_shapes.values()) == {(1, 160, 192, 192), (1, 160, 180, 180)},
              f"preprocessed shapes {pp_shapes}")
        print(f"[cli] plans as the JAX planner's: 3d_fullres {CLI_3D}, 2d {CLI_2D}, no "
              f"3d_lowres; preprocessed shapes {sorted(set(pp_shapes.values()))}")

        with shapes.paused():
            gate_errs, plain_step, case = cli_gate_phase(gen, checked)
        free_memory()

        run("pretrain", cli.pretrain_entry,
            [str(CLI_ID), "-model", "B", "-epochs", "1", "-iters_per_epoch",
             str(CLI_PRETRAIN_ITERS)], StepTimer(pretrain_mod, "anatomask_train_step"))
        pretrained = os.path.join(dirs["results"], CLI_DATASET, "pretrain_anatomask_B",
                                  "checkpoint_final.pt")
        check(os.path.isfile(pretrained), "pretrain: no checkpoint_final.pt")
        tr = "ATKTrainer_1epoch"
        for fold in ("0", "1"):
            run(f"train {tr} fold {fold}", cli.train_entry,
                [str(CLI_ID), "3d_fullres", fold, "-tr", tr, "--npz"],
                StepTimer(Trainer, "train_step"))
        run(f"train {ft} fold 0", cli.train_entry,
            [str(CLI_ID), "3d_fullres", "0", "-tr", ft, "-pretrained_weights", pretrained],
            StepTimer(Trainer, "train_step"))
        models = {m: os.path.join(dirs["results"], CLI_DATASET, f"{m}__ATKPlans__3d_fullres")
                  for m in (tr, ft)}
        for m, folds in ((tr, (0, 1)), (ft, (0,))):
            for fold in folds:
                fdir = os.path.join(models[m], f"fold_{fold}")
                check(os.path.isfile(os.path.join(fdir, "checkpoint_final.npz")),
                      f"{m} fold {fold}: no checkpoint_final.npz")
                summary = load_json(os.path.join(fdir, "validation", "summary.json"))
                check(math.isfinite(summary["foreground_mean"]["Dice"]),
                      f"{m} fold {fold}: validation Dice {summary['foreground_mean']}")
        check(any(f.endswith(".npz") for f in os.listdir(os.path.join(models[tr], "fold_0",
                                                                      "validation"))),
              "train --npz saved no probabilities")

        preds = {tr: os.path.join(root, "pred_atk"), ft: os.path.join(root, "pred_stunet")}
        for m, folds in ((tr, ["0", "1"]), (ft, ["0"])):
            r = run(f"predict {m}", cli.predict_entry,
                    ["-i", os.path.join(raw, "imagesTs"), "-o", preds[m], "-d", str(CLI_ID),
                     "-c", "3d_fullres", "-tr", m, "-f", *folds, "--save_probabilities"])
            forwards = len(folds) * sum(math.ceil(tiles_of((1, *shape)) / 2)
                                        for _, shape, _ in CLI_TEST)
            launches = PLAIN_TILE_LAUNCHES if m == tr else SUP_VAL_LAUNCHES
            want = {k: forwards * launches[k] for k in COUNT_KEYS}
            check(r["launches"] == want, f"predict {m}: launches {r['launches']}, expected {want}")
            print(f"[cli] predict {m}: {r['seconds'] / (len(CLI_TEST) * len(folds)):.3f} s a "
                  f"test case and fold ({forwards} forwards of B={CLI_TILE_BATCH} in all)")
        ens = os.path.join(root, "ensemble")
        run("ensemble", cli.ensemble_entry, ["-i", preds[tr], preds[ft], "-o", ens, "--save_npz"])
        for folder in (preds[tr], preds[ft], ens):
            for name, shape, _ in CLI_TEST:
                seg = NiftiIO().read_seg(os.path.join(folder, name + ".nii.gz"))[0][0]
                check(seg.shape == shape and set(np.unique(seg).tolist()) <= {0, 1, 2},
                      f"{folder}/{name}: shape {seg.shape}, labels {np.unique(seg)}")
                with np.load(os.path.join(folder, name + ".npz")) as z:
                    p = z["probabilities"]
                check(p.shape == (3, *shape) and np.isfinite(p).all(),
                      f"{folder}/{name}.npz: shape {p.shape}")
        dice = {}
        for label, folder in (("ATKTrainer_1epoch", preds[tr]), (ft, preds[ft]),
                              ("ensemble", ens)):
            run(f"evaluate {label}", cli.evaluate_entry,
                [os.path.join(raw, "labelsTs"), folder, "-djfile",
                 os.path.join(preds[tr], "dataset.json")])
            dice[label] = load_json(os.path.join(folder, "summary.json"))["mean"]
            check(all(math.isfinite(v["Dice"]) for v in dice[label].values()),
                  f"evaluate {label}: {dice[label]}")
        print(f"[cli] test Dice per class (random-init models after 10 steps): "
              + "; ".join(f"{k} {({c: round(v['Dice'], 4) for c, v in d.items()})}"
                          for k, d in dice.items()))

        run("find_best_configuration", cli.find_best_configuration_entry,
            [str(CLI_ID), "-c", "3d_fullres", "-tr", tr, "-f", "0", "1"])
        info = load_json(os.path.join(dirs["results"], CLI_DATASET,
                                      "inference_information.json"))
        best = info["best_model_or_ensemble"]
        check(best["configuration"] == "3d_fullres" and not best["ensemble"], f"best {best}")
        pp_file = os.path.join(dirs["results"], CLI_DATASET,
                               f"crossval_results_{tr}__ATKPlans__3d_fullres", "postprocessing.json")
        check(os.path.isfile(pp_file), "find_best_configuration: no postprocessing.json")
        ens_pp = os.path.join(root, "ensemble_postprocessed")
        run("apply_postprocessing", cli.apply_postprocessing_entry,
            ["-i", ens, "-o", ens_pp, "-pp_file", pp_file, "-djfile",
             os.path.join(preds[tr], "dataset.json")])
        check(sorted(f for f in os.listdir(ens_pp) if f.endswith(".nii.gz"))
              == [f"{name}.nii.gz" for name, *_ in CLI_TEST], "apply_postprocessing: outputs")
        run("accumulate_crossval_results", cli.accumulate_crossval_entry,
            [str(CLI_ID), "-tr", tr, "-f", "0", "1"])
        check(os.path.isfile(os.path.join(models[tr] + "_crossval_results", "summary.json")),
              "accumulate_crossval_results: no summary.json")
        print(f"[cli] best: {best['configuration']} (ensemble {best['ensemble']}), Dice "
              f"{best['dice_before_postprocessing']:.4f} -> {best['dice_after_postprocessing']:.4f} "
              f"after postprocessing {best['postprocessing']}")

        zip_file = os.path.join(root, "model.zip")
        run("export_model", cli.export_model_entry,
            [str(CLI_ID), "-o", zip_file, "-tr", tr, "-c", "3d_fullres", "-f", "0", "1"])
        installed = os.path.join(root, "results_installed")
        os.environ["ATK_results"] = installed
        run("install_model", cli.install_model_entry, ["-i", zip_file])
        os.environ["ATK_results"] = dirs["results"]
        case_data = np.asarray(CaseDataset(data_dir, ["case_000"]).load_case("case_000")[0])
        logits = []
        zero_counts()
        for folder in (models[tr], models[tr].replace(dirs["results"], installed)):
            p = Predictor(dtype=torch.bfloat16, device="cuda")
            p.initialize_from_trained_model_folder(folder, [0])
            logits.append(p.predict_sliding_window_return_logits(case_data))
            del p
        runs["installed model"] = dict(launches=counts())
        check(np.array_equal(*logits) and np.isfinite(logits[0]).all(),
              "the installed model's logits differ from the original's")
        print(f"[cli] export_model -> install_model into a second results tree "
              f"({os.path.getsize(zip_file)} bytes of zip): fold 0 predicts logits equal to the "
              f"original's ({logits[0].shape}); launches {runs['installed model']['launches']}")
        del logits

        run("move_plans_between_datasets", cli.move_plans_entry,
            ["-s", str(CLI_ID), "-t", CLI_TARGET])
        moved = load_json(os.path.join(dirs["preprocessed"], CLI_TARGET, "ATKPlans.json"))
        check(moved["dataset_name"] == CLI_TARGET
              and moved["configurations"] == plans["configurations"], "move_plans: plans")
    finally:
        trainer_mod.TRAINER_PRESETS[ft] = preset
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name in ("pretrain", f"train {tr} fold 0", f"train {tr} fold 1", f"train {ft} fold 0",
                 f"predict {tr}", f"predict {ft}"):
        n = runs[name]["launches"]
        check(all(kernel_launches(n, k) > 0 for k in ("conv3x3", "zslab", "moments")),
              f"{name} did not launch every kernel: {n}")
    total = sum(r["seconds"] for r in runs.values() if "seconds" in r)
    print(f"[cli] the entries took {total:.1f} s, the phase {time.perf_counter() - start:.1f} s")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in COUNT_KEYS}
    return launches, gate_errs, plain_step, case


def kernel_record(name, source, replaces, launches_by_path, max_abs, max_rel, totals_by_path,
                  per, launches_by_variant=None):
    """totals_by_path: {path: TOTAL_KEYS totals}; launches_by_path: {path:
    launches in that path's run}; launches_by_variant: a conv's launches over
    the same runs, by variant of csrc/conv3x3_igemm.cuh."""
    both = {k: sum(t[k] for t in totals_by_path.values()) for k in TOTAL_KEYS}
    variants = {} if launches_by_variant is None else {"launches_by_variant": launches_by_variant}
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=sum(launches_by_path.values()), launches_by_path=launches_by_path, **variants,
        max_abs_err=max_abs, max_rel_err=max_rel, checked=True,
        ms=both["ms"], plain_ms=both["plain_ms"], bound_ms=both["bound_ms"],
        bound_by="operations" if both["flop_ms"] >= both["byte_ms"] else "bytes",
        library_ms=both["library_ms"],
        per=per, by_path={p: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                          for p, t in totals_by_path.items()})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    smi = gpu_line()
    print(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = ("conv3x3", "moments", "zslab_conv")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source, all at once
        for lib in pool.map(_build.build, names):
            print(f"[build] {lib.name}")
    for name in names:
        _build.load(name)
    print(f"[build] csrc/{{{','.join(names)}}}.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name in names:
        build_report(name)
    for name in ("conv3x3", "zslab_conv"):
        check_hgmma(name)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    work = tempfile.TemporaryDirectory()
    pretrained = os.path.join(work.name, "pretrain_checkpoint_final.pt")
    (conv_err, conv_rel, conv_step, conv_volume, conv_tile, conv_checked, k1_step,
     k1_infer) = conv_phase(gen)
    free_memory()
    zc_err, zc_rel, zc_step, zc_volume, zc_tile, zc_checked = zconcat_phase(gen, k1_step,
                                                                             k1_infer)
    free_memory()
    mom_err, mom_rel, mom_step, mom_volume, mom_tile, mom_checked = moments_phase(gen)
    free_memory()
    zs_err, zs_rel, zs_probe, zs_variants = zslab_phase(gen)
    zc_err, zc_rel = max(zc_err, zs_err), max(zc_rel, zs_rel)
    free_memory()
    sup_errs, sup_step, plain_step, sup_checked = supervised_gate_phase(gen)
    conv_err, conv_rel = max(conv_err, sup_errs["conv3x3"][0]), max(conv_rel,
                                                                     sup_errs["conv3x3"][1])
    zc_err, zc_rel = max(zc_err, sup_errs["zslab"][0]), max(zc_rel, sup_errs["zslab"][1])
    mom_err, mom_rel = max(mom_err, sup_errs["moments"][0]), max(mom_rel,
                                                                 sup_errs["moments"][1])
    free_memory()
    h_errs, h_step, h_sup, h_checked = h_gate_phase(gen)
    conv_err, conv_rel = max(conv_err, h_errs["conv3x3"][0]), max(conv_rel, h_errs["conv3x3"][1])
    zc_err, zc_rel = max(zc_err, h_errs["zslab"][0]), max(zc_rel, h_errs["zslab"][1])
    mom_err, mom_rel = max(mom_err, h_errs["moments"][0]), max(mom_rel, h_errs["moments"][1])
    free_memory()

    reference_phase()
    remat_phase()
    inference_reference_phase()
    free_memory()
    shapes = LaunchShapes()  # from here on, only the main paths launch kernels
    pretrain, bare_step_ms = slice_phase()
    free_memory()
    inference = inference_phase()
    free_memory()
    trainer = trainer_phase(bare_step_ms, pretrained)
    free_memory()
    with tempfile.TemporaryDirectory() as root:
        files, predictor, ladder_data, case_tiles = files_phase(root)
    free_memory()
    with tempfile.TemporaryDirectory() as root:
        supervised, plain_trainer = supervised_phase(root, pretrained)
    work.cleanup()
    held = torch.cuda.memory_allocated()
    free_memory()
    left = torch.cuda.memory_allocated()
    print(f"[memory] allocated after the supervised phase: {held / 2**30:.2f} GiB ({held} "
          f"bytes); after gc.collect(): {left / 2**30:.2f} GiB ({left} bytes, the files "
          f"phase's predictor among it)")
    h_pretrain, h_step_ms = h_step_phase()
    free_memory()
    with tempfile.TemporaryDirectory() as root:
        h_trainer, h_final = h_trainer_phase(root, h_step_ms)
        free_memory()
        h_finetune = h_transfer_phase(root, h_final)
    free_memory()
    checked = {"conv3x3": conv_checked | sup_checked["conv3x3"] | h_checked["conv3x3"],
               "zslab": zc_checked | sup_checked["zslab"] | h_checked["zslab"],
               "moments": mom_checked | sup_checked["moments"] | h_checked["moments"]}
    with tempfile.TemporaryDirectory() as root:
        cli_launches, cli_errs, cli_step, cli_case = cli_phase(root, gen, checked, shapes)
    free_memory()
    conv_err, conv_rel = max(conv_err, cli_errs["conv3x3"][0]), max(conv_rel,
                                                                    cli_errs["conv3x3"][1])
    zc_err, zc_rel = max(zc_err, cli_errs["zslab"][0]), max(zc_rel, cli_errs["zslab"][1])
    mom_err, mom_rel = max(mom_err, cli_errs["moments"][0]), max(mom_rel,
                                                                 cli_errs["moments"][1])
    for label, seen in (("conv3x3", shapes.conv), ("zslab", shapes.zslab),
                        ("moments", shapes.moments)):
        check(seen <= checked[label],
              f"{label} launches at unchecked shapes: {sorted(seen - checked[label])}")
    print(f"[paths] every launch ran at a checked shape: {len(shapes.conv)} kernel #1, "
          f"{len(shapes.zslab)} kernel #2, {len(shapes.moments)} moments shapes")
    ladder_phase(predictor, ladder_data)  # tile batch 2 launches at B = 16: no path's

    runs = {"pretrain": pretrain, "inference": inference, "pretrain_trainer": trainer,
            "files": files, "supervised": supervised, "plain_trainer": plain_trainer,
            "pretrain_h": h_pretrain, "pretrain_h_trainer": h_trainer, "finetune_h": h_finetune,
            "cli": cli_launches}
    per = ("one pretraining step (B = 4), one inference volume (18 STUNet-B tiles at B = 8), "
           f"one case of the file path ({case_tiles} PlainConvUNet tiles at B = 8), one "
           "STUNet-B finetuning step and one ATKTrainer PlainConvUNet step (B = 2), one "
           "STUNet-H pretraining step (B = 4 in two microbatches, remat) and one "
           "STUNetTrainer_huge step (B = 2, remat), one step of the planner's PlainConvUNet "
           "(one input channel, B = 2) and one test case and fold of the command line's predict "
           f"({math.ceil(tiles_of((1, *CLI_TEST[0][1])) / 2)} forwards at B = {CLI_TILE_BATCH}); "
           "by_path splits them; launches_by_path "
           "counts every launch of each path's run, the PretrainTrainer runs', the "
           "supervised runs' (training, resume, final validation, checkpoint round trip, bare "
           "steps), the ATKTrainer steps', the H phases' (bare, profiled and ride-along "
           "steps; the H trainer's two runs; the H finetuning steps) and the command line's "
           "(every entry, and the installed model's check) too")

    def case(tile):  # one PlainConvUNet tile's totals -> one case's
        return {k: case_tiles * v for k, v in tile.items()}

    def launches(kernel):
        return {path: kernel_launches(c, kernel) for path, c in runs.items()}

    def by_variant(kernel):
        return {v: sum(c[f"{kernel}.{v}"] for c in runs.values()) for v in ("hopper", "simple")}

    zslab_record = kernel_record(
        "conv3d_zslab", "anatomask_torch/csrc/zslab_conv.cu",
        "anatomask_tpu/ops/pallas_zslab_conv.py:142", launches("zslab"), zc_err, zc_rel,
        {"pretrain_step": zc_step, "inference_volume": zc_volume, "files_case": case(zc_tile),
         "supervised_step": sup_step["zslab"], "plain_trainer_step": plain_step["zslab"],
         "pretrain_h_step": h_step["zslab"], "finetune_h_step": h_sup["zslab"],
         "cli_plain_step": cli_step["zslab"], "cli_case": cli_case["zslab"]},
        per + "; the main paths' per-tap forwards through conv3d_zconcat", by_variant("zslab"))
    zslab_record["probe"] = {"launches_by_variant": zs_variants, **{
        k: zs_probe[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "per": "one forward + dx (through conv3d_zslab, per-tap dx) at each shape of "
               "probes/probe_pallas_v4.py: dec3 and enc0, B = 4, bf16"}
    moments_record = kernel_record(
        "row_moments", "anatomask_torch/csrc/moments.cu", "probes/probe_rowstats.py:53",
        launches("moments"), mom_err, mom_rel,
        {"pretrain_step": mom_step[0], "inference_volume": mom_volume[0],
         "files_case": case(mom_tile[0]), "supervised_step": sup_step["moments"],
         "plain_trainer_step": plain_step["moments"], "pretrain_h_step": h_step["moments"],
         "finetune_h_step": h_sup["moments"], "cli_plain_step": cli_step["moments"],
         "cli_case": cli_case["moments"]},
        per + "; ms is the call (host and device, CUDA events), device_ms the kernel "
        "(torch.profiler)")
    case_dev = None if mom_tile[1] is None else case_tiles * mom_tile[1]
    moments_record["device_ms"] = (None if None in (mom_step[1], mom_volume[1], case_dev)
                                   else mom_step[1] + mom_volume[1] + case_dev)
    moments_record["by_path"]["pretrain_step"]["device_ms"] = mom_step[1]
    moments_record["by_path"]["inference_volume"]["device_ms"] = mom_volume[1]
    moments_record["by_path"]["files_case"]["device_ms"] = case_dev
    kernels = [
        kernel_record("conv3d_3x3", "anatomask_torch/csrc/conv3x3.cu",
                      "anatomask_tpu/ops/pallas_conv.py:108", launches("conv3x3"),
                      conv_err, conv_rel,
                      {"pretrain_step": conv_step, "inference_volume": conv_volume,
                       "files_case": case(conv_tile), "supervised_step": sup_step["conv3x3"],
                       "plain_trainer_step": plain_step["conv3x3"],
                       "pretrain_h_step": h_step["conv3x3"], "finetune_h_step": h_sup["conv3x3"],
                       "cli_plain_step": cli_step["conv3x3"], "cli_case": cli_case["conv3x3"]},
                      per,
                      by_variant("conv3x3")),
        moments_record,
        zslab_record,
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

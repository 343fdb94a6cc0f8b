#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (anatomask_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which raises on a failed check:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/conv3x3.cu, csrc/moments.cu, csrc/zslab_conv.cu and
   csrc/norm_act.cu (the two convs share the kernels of csrc/conv3x3_igemm.cuh, its hopper,
   tf32x3 and simple variants, and of csrc/conv3x3_stem.cuh, the stem
   variant, bf16 on wgmma and fp32 on the FP32 pipe) for sm_90a from the
   checkout's sources, one nvcc each, all at once; print each kernel's
   registers and spills from ptxas's report, and check with cuobjdump's
   SASS that every hopper, tf32x3 and bf16 stem instantiation of both conv
   libraries holds HGMMA (wgmma) instructions, TF32 ones in the tf32x3
   kernels, and every fp32 stem instantiation FFMA and no HGMMA;
3. conv kernel (TPU kernel #1): at every call site of the stride-1 3x3x3
   conv on the main paths (the paths run it for the forwards below
   MIN_VOLUME output voxels and for every dx; the table checks all), the
   kernel against its plain PyTorch version on the card. For the
   pretraining step: forward and dx (bf16 at B = 1 through the autograd
   Function and at the step's B = 4, relative max error <= 1e-2; fp32
   without TF32 on a few shapes, <= 1e-5), and at B = 4 (but the stem's dx,
   which no path launches) its time beside the
   bound, the plain version's time and F.conv3d's (a yardstick only; the port
   never calls it for this conv). For inference: forward at the tile
   forward's B = 8 (the 8 mirror flips), <= 1e-2, and the same times. Then
   bf16 shapes off the paths at the hopper variant's edges (ragged M, F = 96
   and 160 with BN = 32, C = 96 and 160 with BK = 32), fwd + dx, <= 1e-2;
   the float64 guard at the B step's longest K (512 -> 512, K = 13824:
   enc4.conv2 and dec0.conv0): the hopper variant may round at most twice
   as many elements to another bf16 value than the float64 sum as the plain
   version (fp32 sums) does (ROADMAP.md section 3, fault 13); then kernel #2 at every shape where the paths run it (the per-tap
   forwards, >= MIN_VOLUME output voxels; models/layers.py ConvND): forward
   and dx through conv3d_zconcat (dx is kernel #1, rounded once) at the
   step's B = 4, forward at inference's B = 8, against the plain versions,
   rel. max error <= 1e-2, bit-equal on >= 95% of the elements, kernel #1's
   forward at least 10 points lower; its time beside kernel #1's. Before
   it, the stem table: the stem variant (bf16, C <= 8: every network's first
   conv) at every stem shape of the paths and at edge shapes off them
   (ragged extents, padding 0 and 2, C = 2, 5, 8, F = 16 and 48), both
   roundings against their plain versions (per tap: kernel #2's gates;
   once: rel. max error <= 1e-2); at each path shape the per-tap stem's
   time beside its byte bound and share, the once-rounded stem's, both plain
   versions', F.conv3d's and the simple variant's at the same shape (timed
   through its C entry point, the yardstick it replaced, its output held
   to the per-tap plain version; the port never calls it there);
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
4b. norm epilogue kernel (csrc/norm_act.cu, no TPU kernel): at every plain
   norm shape of a tile (B = 8; a block's norm1 and norm2) and of the
   step's teacher decoder (B = 4, bare), bf16 and fp32, the kernel against
   its plain version, the op sequence it replaces, bit for bit with a (B,
   C) and a (1, C) affine, and the moments kernel with the conv's bias
   against it on the biased tensor, bit for bit; in bf16 the kernel's time
   beside its byte bound and the op sequence's, and the moments' with and
   without the bias; then four shapes off the paths in every mode;
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
5b. the block-sparse route's launches (ATK_BLOCK_SPARSE=1 on the pretraining
   step: stages 0-1 on the 4 x 157 visible 16^3 patches alone): kernel #2 at
   padding 0 (VALID on 628 halo'd blocks of 18^3 and 10^3) forward and
   kernel #1 at padding 2 (its dx) against the plain versions with the gates
   of 3 (bf16 <= 1e-2, bit-equal >= 95%), off-path shapes at both paddings
   on both kernels in bf16 (<= 1e-2) and fp32 (<= 1e-5), the block norms'
   moments (no mask, x squared in fp32; <= 1e-5, two calls bit-equal); each
   launch's time beside its bound, the plain version's and F.conv3d's or
   torch.var_mean's;
5c. the float32 path's launch shapes (`-compute_dtype float32`: the B
   step's forwards at B = 4 and its dx, a volume tile's forwards at B = 8),
   from a generator of their own, and three fp32 stems that users reach
   (FP32_STEM_SHAPES: 4 -> 32 at a B = 8 128^3 tile, 3 -> 32 at B = 16, 1
   -> 96 at B = 2 on 112x112x128): each kernel's forward on the variant the
   rule picks (tf32x3; the stems stem, on the FP32 pipe, with kernel #1's
   once-rounded stem gated and timed beside it) against its plain version,
   rel. max error <= 1e-5; its time beside the simple variant's at the same
   shape (the kernel it replaced, through its C entry point), the plain
   version's, F.conv3d's in fp32 with TF32 off and the bound (three TF32
   products a term at 495 TFLOP/s, or the bytes; the FP32 pipe's time
   beside it); the totals of one B step and one volume;
6. references, with PyTorch's default TF32 flags set back first (the
   float32 SparK's setup, build_spark_model, must turn TF32 off): a tiny
   SparK (also with densify norm "bn", with "ln", in
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
   stem, 44 moments; `path_launches` counts them from the site tables with
   the port's variant rule, ops/conv3x3.py `conv_variant`), the norm
   epilogue's 8 (the teacher's decoder) and the EMA law, timing the last 3 steps, then 3 more;
7b. the block-sparse route: the STUNet-B encoder in fp32 with
   ATK_BLOCK_SPARSE=1 against without it (every feature within 1e-5 of its
   largest entry), two bf16 backward passes through it (bit-equal
   gradients), then 7's 5 steps with it from the same weights and draws,
   checking the launches by kernel and variant (as 7's) and by padding
   (kernel #2 6 at 0, kernel #1 2 at 2), printing step ms, patches/s and
   peak memory beside 7's dense step;
7c. the float32 pretraining step: 7's 5 steps in fp32 (compute_dtype
   "float32", the model built after PyTorch's default TF32 flags are set
   back, which its setup must turn off) with 7's checks, launches by kernel
   and variant every conv on tf32x3 but the stem's two (stem); its first
   step also run on copies of its weights and draws with cuDNN in TF32 and,
   for the spread, with TF32 off again: each copy's loss and gradients
   against the step's; step ms, patches/s, peak memory;
8. inference: bench_inference.py's configuration at full width through the
   Predictor: STUNet-B (6 stages, 1 input channel, 3 classes), a
   240x240x155 volume, patch 128^3, step 0.5, 18 tiles, 8-flip mirror TTA,
   tile batch 1, bf16; 3 volumes, the first a warm-up, checking finite
   logits of shape (3, 240, 240, 155) and, a tile, 7 kernel #1 (hopper), 10
   kernel #2 (9 hopper, the stem on the stem variant), 22 moments and 22
   norm epilogue launches;
   then 1 volume in fp32 through Predictor(dtype=torch.float32), built
   after PyTorch's default TF32 flags are set back (its setup must turn
   them off): the same checks, the convs on tf32x3 but the stem (stem);
   s a volume, peak memory;
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
   then a float32 run (compute_dtype "float32", 1 epoch x 2 iterations with
   the case cache), its trainer built after PyTorch's default TF32 flags
   are set back, with the same checks (fp32 launches);
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
   variant (a tile: 7 kernel #1, 10 kernel #2 of which the C = 4 stem on the
   stem variant, 22 moments), and predict_single_npy_array against the
   resampled case's
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
   trainer's network (<= 1e-3), the bare step (median of steps 3-5, then 3
   more) and a validation step,
   then 3 bare ATKTrainer steps of phase 10's PlainConvUNet (SGD) and 3
   bare ATKTrainerDA5 steps on the same batch (p_rotation 0.4, DA5's extras
   and intensity settings), its augmentation timed alone, and one batch of
   it with every DA5 transform on, on the card against the CPU with the
   same draws (<= 1e-5 of the largest value where the seg targets agree,
   the targets equal on >= 99.99%); checking
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
   forward of every stage and decoder block, and dx), 2 more steps, a step
   at grad_accum_steps=1 and a LAMB step; then
   PretrainTrainer.run_pretraining at H for 1 epoch x 2 iterations with the
   case cache, validation and checkpoints (an epoch's one ~12.8 GB file
   under all its names, written into a temporary folder after a check that
   the disk holds three, its GB and seconds printed); then
   load_ssl_encoder_into_trainer
   from its checkpoint_final.pt into STUNetTrainer_huge (remat) and 2 bare
   supervised steps at 128^3, batch 2; step ms and peak memory of each;
13. the command line (anatomask_torch/cli.py), entry by entry with the argv
   a user types, from a raw dataset to ensembled, postprocessed
   segmentations, in a temporary ATK_raw/ATK_preprocessed/ATK_results tree
   deleted at its end: a KiTS-like CT dataset (CLI_TRAIN, CLI_TEST: int16
   HU, labels background/kidney/tumour, two cases resampled) written with
   the port's NIfTI writer and generate_dataset_json, and
   plan_and_preprocess (--verify_dataset_integrity, 4 spawned workers),
   both in the preparing process (below), whose plans must be the
   JAX planner's (3d_fullres PlainConvUNet 32-320, 6 stages, patch 128^3,
   batch 2; 2d 192^2, batch 64; no 3d_lowres); then the launch shapes those
   plans imply held against the plain versions with the gates above (the
   PlainConvUNet step at B = 2 and its tile forward at B = 16, timed; the
   pretraining microbatch B = 2); pretrain (atk_pretrain's defaults at
   STUNet-B, 1 epoch x 3 iterations); train ATKTrainer_1epoch fold 0
   --npz and STUNetTrainer_base_ft from the pretraining checkpoint (10
   iterations, 2 validation iterations); predict the test case with both
   (launches by kernel and variant checked per forward); ensemble;
   evaluate; find_best_configuration; apply_postprocessing;
   accumulate_crossval_results; export_model (fold 0) and install_model
   into a second results tree, whose fold 0 must predict logits equal to the
   original's; move_plans_between_datasets. Every output is read back;
   pretrain, both trains and predict must each launch all three kernels.
   Printed: each entry's seconds, peak memory and launches, the steps'
   median ms, seconds a test case and fold;
14. the cascade (3d_lowres -> 3d_cascade_fullres) through the same
   entries on a KiTS-like dataset large enough for the planner to add
   3d_lowres (CASCADE_TRAIN, CASCADE_TEST: a test case at 1.6 mm):
   plan_and_preprocess -c 3d_fullres 3d_lowres in the preparing process,
   whose plans must be the JAX planner's; the cascade network's launch
   shapes (the C = 3 stem on kernel #2's stem variant) held against the
   plain versions at B = 2 and 16, timed; train ATKTrainer_1epoch 3d_lowres fold all, then
   3d_cascade_fullres fold 0 from its predicted_next_stage; predict the
   test case with 3d_lowres, then with the cascade from those predictions.
   Checked: the plans, every case's predicted_next_stage, the cascade
   network's 3 input channels, its summary.json, every output's raw shape
   and labels, each entry's launches by kernel and variant;
15. data parallelism (anatomask_torch/parallel/mesh.py): the per-rank
   launch shapes held against the plain versions first (the pretraining
   microbatch B = 1 and the STUNet-B finetuning step at B = 1, timed; the
   32-320 PlainConvUNet at B = 1); then, at world 1 without a group in this
   process: 3 AnatoMask steps at full STUNet-B width (global batch 4 in 2
   microbatches, bf16), the same with the batch-pooled norms and decoder
   norm "bn", a val step and 2 train steps of STUNetTrainer_base_ft
   (STUNet-B) and ATKTrainerBN (the 32-320 PlainConvUNet with BatchNorm)
   at 128^3 (global batch 2, batch Dice) on one seeded global batch and
   draws, recorded for 15b; then a rank that mesh.launch spawns at world 1
   on "cuda" (NCCL, card 0) runs the first pretraining case, which must
   equal world 1 without a group bit for bit;
15b. training across nodes (parallel/mesh.py run_joined, cli.py), in 15's
   folder, after it: PyTorch's launcher (python -m torch.distributed.run)
   starts one node of one process over NCCL (-device cuda: its card
   LOCAL_RANK), which runs 15's step cases bit-equal to world 1 without a
   group, and at the same time two nodes on 127.0.0.1 of one process each
   (this script with --multinode-rank), which join one group from its
   variables and share the card over gloo (-device cuda:0); as global ranks
   0 and 1 they
   run 15's step cases at world 2 (2 rows a rank, 1 in the supervised
   cases): the ranks' weights and teachers bit-identical after every step,
   world 2 within DDP_LOSS_RTOL, DDP_WEIGHT_TOL and DDP_COUNT_RTOL of world
   1, each rank's launches by kernel and variant; then `pretrain`
   (STUNet-B, global batch 2, 1 epoch x 2 iterations) and a resume, and
   `train` STUNetTrainer_base_ft fold 0 (1 epoch x 2 iterations + 1
   validation iteration) and a resume, each with its final validation,
   through cli.main as `torchrun -m anatomask_torch.cli` runs them:
   checkpoint files written by global rank 0 alone, validation cases
   [rank::2] of fold 0, rank 0's summary.json listing every case, kernels
   #1, #2 and #3 launched by every rank in every entry. Printed: each start's
   seconds, a rank's step ms at world 1 and 2, the gloo all-reduce of the
   gradients, peak memory a rank, each entry's seconds;
16. the out-of-memory ladder: one volume at tile batch 2 under a
   torch.cuda.set_per_process_memory_fraction cap between the uncapped tile
   batch 1 and 2 peaks: the device-resident path must run out at 2, finish
   at 1, and match the uncapped tile batch 1 logits within 1e-3 relative.

A kernel's time is the median of three runs of back-to-back calls, each run
timed with CUDA events, after a warm-up call; a plain conv's (a yardstick,
10-700 ms a call) one call after the warm-up, and a launch shape that an
earlier phase of the run timed keeps that phase's times. Each main path
(7-15b, 7b included) runs with the launch counts set to 0 just before it and
read just after (13: each entry; 15: the spawned rank's runs; 15b: each
rank's runs and entries), and every launch it makes (15, 15b: in every rank)
must be at a shape that phases 3, 4 and 5b (and 11's to 15's gates) held
against the plain version (kernel #2's: its path shapes in phase 3); phase
16 runs after that check, as its tile batch 2 launches at B = 16 on the
4-channel PlainConvUNet. Between phases, free_memory collects reference
cycles and empties the allocator's cache, so that each phase's memory peaks
count its own tensors; after phase 11 it prints what stayed allocated before
and after the collection. A [time] line after each phase gives the script's
seconds so far. The host work that 13 and 14 begin with (writing each raw
dataset, plan_and_preprocess) runs in a process of its own at the lowest
priority (nice 19), started after the kernel phases (3-5b), beside 6-12;
13 and 14 wait for its part and print its output and seconds. 14's gates
run after 13, then 15; 15b's nodes start after 15 and run beside 14's
entries, and are checked after them. The last three lines of standard
output are the nvidia-smi line, one JSON object {"kernels": [...]} (kernels
#1, #3 and #2, then the float32 path's tf32x3 variant of #1 and #2 and its
stem variant of #2), and {"ok": true, "device": {...}}; before them a
check that no path's run launched the simple variant."""
import atexit
import copy
import gc
import hashlib
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
from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as fn

from anatomask_torch import cli
from anatomask_torch.convert import plain_unet_state_dict_from_jax, state_dict_to_jax
from anatomask_torch.data.augment import apply_train_augment, draw_all
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
from anatomask_torch.ops.conv3x3 import (HOPPER_TILES, STEM_MAX_C, TF32_TILES, VARIANTS,
                                         conv3d_3x3, conv3d_3x3_forward, conv3d_3x3_plain,
                                         conv_variant, flip_weight, igemm_variant, out_extents,
                                         pack_weight, zero_launch_counts)
from anatomask_torch.ops.moments import row_moments, row_moments_forward, row_moments_plain
from anatomask_torch.ops.norm_act import norm_act, norm_act_plain
from anatomask_torch.ops.zslab_conv import (conv3d_zconcat, conv3d_zslab, conv3d_zslab_forward,
                                            conv3d_zslab_plain)
from anatomask_torch.parallel import mesh
from anatomask_torch.plans.plans_handler import PlansManager, load_json, save_json
from anatomask_torch.preprocessing.preprocessor import save_properties
from anatomask_torch.preprocessing.resampling import compute_new_shape
from anatomask_torch.ssl.pretrain import (Lamb, PretrainConfig, PretrainTrainer,
                                          accumulation_steps, anatomask_train_step,
                                          build_spark_model, load_ssl_encoder_into_trainer,
                                          make_optimizer, make_teacher)
from anatomask_torch.ssl import pretrain as pretrain_mod
from anatomask_torch.ssl.decoder import DSDecoder, SMiMDecoder, SMiMTwoDecoder
from anatomask_torch.ssl.sparse import (SparseConvNeXtBlock, SparseSTUNetEncoder,
                                        mask_to_resolution, upsample_mask)
from anatomask_torch.ssl.spark import random_keep_mask, spark_loss
from anatomask_torch.training import checkpoint as ckpt_mod
from anatomask_torch.training import trainer as trainer_mod
from anatomask_torch.training.checkpoint import load_trainer_checkpoint, save_checkpoint
from anatomask_torch.training.trainer import Trainer, get_trainer_config

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 rate outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
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
FP32_TRAINER_ITERS = 2  # the float32 run: 1 epoch of these and a validation step
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
# that preprocessing resamples, a test case with labels
CLI_ID = 953
CLI_DATASET, CLI_TARGET = f"Dataset{CLI_ID}_ChipSmokeCli", "Dataset954_ChipSmokeCliTarget"
CLI_LABELS = {"background": 0, "kidney": 1, "tumor": 2}
CLI_TRAIN = ([(f"case_{i:03d}", (160, 192, 192), (1.5, 0.8, 0.8)) for i in range(6)]
             + [(f"case_{i:03d}", (120, 144, 144), (2.0, 1.0, 1.0)) for i in (6, 7)])
CLI_TEST = [("test_000", (160, 192, 192), (1.5, 0.8, 0.8))]
# what the JAX planner plans for it: nnU-Net's 3d_fullres PlainConvUNet
# (PLAIN_FEATURES, PLAIN_RES) for one channel, patch 128^3, batch 2; 2d
# at patch 192^2, batch 64; no 3d_lowres
CLI_3D = {"UNet_class_name": "PlainConvUNet", "patch_size": [128, 128, 128], "batch_size": 2,
          "UNet_base_num_features": 32, "unet_max_num_features": 320,
          "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 5,
          "conv_kernel_sizes": [[3, 3, 3]] * 6, "n_conv_per_stage_encoder": [2] * 6,
          "n_conv_per_stage_decoder": [2] * 5, "normalization_schemes": ["CTNormalization"]}
CLI_2D = {"patch_size": [192, 192], "batch_size": 64}
CLI_ITERS, CLI_VAL_ITERS, CLI_PRETRAIN_ITERS = 8, 2, 3
CLI_TILE_BATCH = 2 * TTA_BATCH  # the Predictor's tile batch 2 x 8 flips
# the cascade phase: a KiTS-like raw dataset whose cases are large enough for
# the planner to add 3d_lowres and 3d_cascade_fullres (5 training cases of
# 224x256x256 at 1.0x0.8x0.8 mm, the anatomy of kidney_case; a test case
# at 1.6 mm along z, so that its data and the previous stage's segmentation
# are resampled: 224x256x256 at the fullres spacing)
CASCADE_ID = 955
CASCADE_DATASET = f"Dataset{CASCADE_ID}_ChipSmokeCascade"
CASCADE_TRAIN = [(f"case_{i:03d}", (224, 256, 256), (1.0, 0.8, 0.8)) for i in range(5)]
CASCADE_TEST = [("test_000", (140, 256, 256), (1.6, 0.8, 0.8))]
# what the JAX planner plans for it (tests/test_torch_cascade.py holds the
# port's planner to these and to the JAX planner): 3d_fullres is CLI_3D at
# 1.0x0.8x0.8 mm; 3d_lowres the same network at a coarser spacing, its
# next stage the cascade, which inherits 3d_fullres and reads 1 + 2 channels
CASCADE_FULLRES_SPACING = (1.0, 0.8, 0.8)
CASCADE_LOWRES = dict(CLI_3D, batch_dice=False, next_stage="3d_cascade_fullres")
CASCADE_LOWRES_SPACING = (1.2298738654248702, 0.9838990923398963, 0.9838990923398963)
CASCADE_STAGE = {"inherits_from": "3d_fullres", "previous_stage": "3d_lowres"}
CASCADE_IN = 1 + 2
# what the cli and cascade phases run first and which needs no card, made by
# a process of its own beside the phases before them (prepare_main): a
# phase's dataset (write_cli_dataset's arguments), then plan_and_preprocess
# with the argv a user types
PREPARED = (("cli", (CLI_DATASET, CLI_TRAIN, CLI_TEST, 4),
             ["-d", str(CLI_ID), "-c", "3d_fullres", "--verify_dataset_integrity", "-np", "4"]),
            ("cascade", (CASCADE_DATASET, CASCADE_TRAIN, CASCADE_TEST, 5),
             ["-d", str(CASCADE_ID), "-c", "3d_fullres", "3d_lowres", "-np", "4"]))
PREPARE_TIMEOUT = 900  # seconds a phase waits for its part of the preparing process
# the DA5 steps of the supervised phase, and its augmentation's calls timed alone
DA5_STEPS = 3
STEPS, WARMUP = 5, 2
FMAP, LEN_KEEP = (7, 7, 8), 157  # the step's patch grid and visible patches
# the block-sparse route (ATK_BLOCK_SPARSE=1, two stages): stages 0 and 1 of
# the step's encoder run on the LEN_KEEP visible 16^3 patches a sample alone,
# BLOCKS blocks of 16^3 at stage 0 and 8^3 at stage 1
BLOCKS = BATCH * LEN_KEEP
# (call site, C, F, halo'd edge e) of each stride-1 block conv of one forward:
# kernel #2 at padding 0 (e^3 -> (e-2)^3); the dx of each but the stem is
# kernel #1 at padding 2 ((e-2)^3 -> e^3)
BLOCK_SITES = (("enc0.conv1", 1, 32, 18), ("enc0.conv2", 32, 32, 18), ("enc1.conv2", 64, 64, 10))
# (call site, block edge, C) of each block norm: the moments of (B, K * bs,
# bs, bs, C), no mask, x squared in fp32
BLOCK_NORMS = (("enc0.norm1", 16, 32), ("enc0.norm2", 16, 32), ("enc1.norm1", 8, 64),
               ("enc1.norm2", 8, 64))
# a block step's launches by padding (two forwards, the student's dx): the
# block sites' forwards at 0, their dx at 2, every other conv at 1 as in a
# dense step
BLOCK_STEP_PADDINGS = {"conv3x3.p0": 0, "conv3x3.p1": 32, "conv3x3.p2": 2,
                       "zslab.p0": 6, "zslab.p1": 10, "zslab.p2": 0}
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
    m = re.search(r"conv3x3_tf32x3ILi(\d+)ELb([01])E", mangled)
    if m:
        return f"tf32x3 BN={m[1]}{' per-tap' if m[2] == '1' else ''}"
    m = re.search(r"conv3x3_kernelI(f|13__nv_bfloat16)Lb([01])E", mangled)
    if m:
        return f"simple {'fp32' if m[1] == 'f' else 'bf16'}{' per-tap' if m[2] == '1' else ''}"
    m = re.search(r"stem_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return f"stem C={m[1]}{' per-tap' if m[2] == '1' else ''}"
    m = re.search(r"stem_fp32_kernelILi(\d+)ELb([01])E", mangled)
    if m:
        return f"stem fp32 C={m[1]}{' per-tap' if m[2] == '1' else ''}"
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
        elif "warning" in line or "Performance Loss" in line:  # e.g. wgmma serialized
            print(f"[build] {name}: {line.strip()}")


def check_hgmma(name):
    """Every hopper, tf32x3 and bf16 stem instantiation of csrc/<name>.cu holds
    HGMMA instructions in its SASS (cuobjdump, beside nvcc), TF32 ones in the
    tf32x3 kernels: a build that lost wgmma fails. Every fp32 stem
    instantiation holds FFMA (the FP32 pipe) and no HGMMA."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, ffma = {}, {}
    for chunk in sass.split("Function : ")[1:]:
        label = kernel_label(chunk.split(None, 1)[0])
        lines = chunk.splitlines()
        if label.startswith("stem fp32"):
            ffma[label] = (sum("FFMA" in line for line in lines),
                           sum("HGMMA" in line for line in lines))
        elif label.startswith(("hopper", "stem", "tf32x3")):
            kind = "TF32" if label.startswith("tf32x3") else ""
            counts[label] = sum("HGMMA" in line and kind in line for line in lines)
    check(len(counts) == len(HOPPER_TILES) + len(TF32_TILES) + STEM_MAX_C
          and all(counts.values()),
          f"{name}: HGMMA instructions by hopper, tf32x3 and stem kernel {counts}")
    check(len(ffma) == STEM_MAX_C and all(f and not h for f, h in ffma.values()),
          f"{name}: (FFMA, HGMMA) instructions by fp32 stem kernel {ffma}")
    print(f"[build] {name}: HGMMA instructions in each of its {len(counts)} hopper, tf32x3 "
          f"(TF32 HGMMA) and stem kernels: "
          f"{', '.join(f'{k} {v}' for k, v in sorted(counts.items()))}; FFMA in each of its "
          f"{len(ffma)} fp32 stem kernels (no HGMMA): "
          f"{', '.join(f'{k} {f}' for k, (f, _) in sorted(ffma.items()))}")


def zero_counts():
    """Every kernel wrapper's launch counts to 0."""
    zero_launch_counts(conv3d_3x3)
    zero_launch_counts(conv3d_zslab)
    row_moments.launches = 0
    norm_act.launches = 0


COUNT_KEYS = tuple(f"{k}.{v}" for k in ("conv3x3", "zslab") for v in VARIANTS) + ("moments",)


def counts():
    """Launches so far: each conv kernel's by variant, and the moments kernel's."""
    return {**{f"conv3x3.{v}": n for v, n in conv3d_3x3.launches_by_variant.items()},
            **{f"zslab.{v}": n for v, n in conv3d_zslab.launches_by_variant.items()},
            "moments": row_moments.launches}


def since(before):
    now = counts()
    return {k: now[k] - before[k] for k in COUNT_KEYS}


def padding_counts():
    """Each conv kernel's launches so far by padding (1: 'same'; 0 and 2: the
    block-sparse route's VALID forward and its dx)."""
    return {f"{label}.p{p}": n for label, fn_ in (("conv3x3", conv3d_3x3), ("zslab", conv3d_zslab))
            for p, n in fn_.launches_by_padding.items()}



def per_tap(vol):
    """The main path rounds this 3x3x3 conv per tap: its forward runs kernel #2
    (models/layers.py ConvND), its dx kernel #1."""
    return math.prod(vol) >= MIN_VOLUME


def path_launches(sites, norms, forwards, backward, stem=True, dtype=torch.bfloat16):
    """The launches of `forwards` forwards over `sites` and `norms` and, with
    `backward`, one backward (dx at every site but the stem, sites[0] where
    `stem`, whose input carries no gradient; the norms' backward is
    elementwise), each conv on the variant the port's rule picks for its
    C -> F in `dtype` (the dx: F -> C)."""
    want = dict.fromkeys(COUNT_KEYS, 0)
    for i, (name, C, F, vol) in enumerate(sites):
        want[f"{'zslab' if per_tap(vol) else 'conv3x3'}."
             f"{conv_variant(dtype, C, F)}"] += forwards
        if backward and (i > 0 or not stem):
            want[f"conv3x3.{conv_variant(dtype, F, C)}"] += 1
    want["moments"] = forwards * len(norms)
    return want


def norm_act_launches(norms, forwards=1):
    """The one-pass norm epilogue's launches in `forwards` forwards that
    autograd does not record, over `norms`: one a plain norm (the masked
    ones, SparseInstanceNorm, keep the op sequence)."""
    return forwards * sum(not masked for *_, masked in norms)


# a pretraining step (two forwards and the student's backward), a validation
# step and a tile forward
STEP_LAUNCHES = path_launches(SITES, PRETRAIN_NORMS, 2, True)
VAL_LAUNCHES = path_launches(SITES, PRETRAIN_NORMS, 1, False)
# a dense step's launches by padding: every conv at 1
STEP_PADDINGS = {k: (sum(STEP_LAUNCHES[f"{k[:-3]}.{v}"] for v in VARIANTS)
                     if k.endswith("p1") else 0) for k in BLOCK_STEP_PADDINGS}
TILE_LAUNCHES = path_launches(INFER_SITES, INFER_NORMS, 1, False)
# the norm epilogue's launches: a tile forward's 22 norms; a pretraining
# step's teacher, whose LightDecoder's 8 norms are plain (the student's
# forward runs under autograd)
TILE_NORM_ACT = norm_act_launches(INFER_NORMS)
STEP_NORM_ACT = norm_act_launches(PRETRAIN_NORMS)
# the same in float32 (-compute_dtype float32): tf32x3 for every conv but
# the stem's (stem)
FP32_STEP_LAUNCHES = path_launches(SITES, PRETRAIN_NORMS, 2, True, dtype=torch.float32)
FP32_VAL_LAUNCHES = path_launches(SITES, PRETRAIN_NORMS, 1, False, dtype=torch.float32)
FP32_TILE_LAUNCHES = path_launches(INFER_SITES, INFER_NORMS, 1, False, dtype=torch.float32)
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
H_STEPS, H_EXTRA_STEPS, H_SUP_STEPS = 5, 2, 2


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


def plain_ms(f):
    """ms of one call of a plain conv version after a warm-up call (a
    yardstick: one run, not time_ms's three)."""
    return time_ms(f, 1, rounds=1)


def conv_flops(C, F, vol, batch=BATCH, padding=1):
    return 2 * batch * math.prod(n + 2 * padding - 2 for n in vol) * 27 * C * F


def bound_ms(C, F, vol, batch=BATCH, itemsize=2, padding=1):
    """(FLOP ms, byte ms) of one conv of the (batch, *vol, C) input: x and
    the weight read once, y written once; the 27-tap products at the bf16
    rate, or in fp32 (itemsize 4) as three TF32 products each, the least
    time for products accurate to fp32 on the tensor cores."""
    voxels = batch * math.prod(vol)
    out = batch * math.prod(n + 2 * padding - 2 for n in vol)
    rate = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_TF32_FLOPS / 3
    nbytes = (voxels * C + 27 * C * F + out * F) * itemsize
    return conv_flops(C, F, vol, batch, padding) / rate * 1e3, nbytes / PEAK_BYTES * 1e3


def fp32_pipe_ms(C, F, vol, batch=BATCH):
    """The conv's products at the FP32 pipe's rate (outside the tensor cores)."""
    return conv_flops(C, F, vol, batch) / PEAK_FP32_FLOPS * 1e3


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
    plain = plain_ms(lambda: conv3d_3x3_plain(x, w))
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


def round_bf16_64(v):
    """float64 -> the nearest bf16 value (ties to even), as float32."""
    m, e = torch.frexp(v)  # |m| in [0.5, 1)
    return torch.ldexp(torch.round(m * 256.0), e - 8).float()


def conv64(x, w):
    """The float64 conv of x (NDHWC) by w (DHWIO) at padding 1, as NDHWC."""
    y = fn.conv3d(x.permute(0, 4, 1, 2, 3).double(), w.permute(4, 3, 0, 1, 2).double(),
                  padding=1)
    return y.permute(0, 2, 3, 4, 1)


# kernel #1's longest chains in the B step (K = 27 * 512 = 13824), where its
# bf16 hopper variant is held to float64: it may round at most K1_GUARD_LIMIT
# times as many elements to another bf16 value than the float64 sum as the
# plain version (fp32 sums) does (ROADMAP.md section 3, fault 13)
K1_GUARD_SITES = ("enc4.conv2", "dec0.conv0")
K1_GUARD_LIMIT = 2.0


def k1_guard():
    """The float64 guard of kernel #1's bf16 hopper variant at K1_GUARD_SITES
    (B = 4, inputs from a generator of their own): the share of elements that
    the kernel and the plain version each round to another bf16 value than
    the float64 sum of the 27 * C products rounded once."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    t0 = time.perf_counter()
    for name, C, F, vol in (site for site in SITES if site[0] in K1_GUARD_SITES):
        x, w = conv_inputs(C, F, vol, BATCH, torch.bfloat16, gen)
        check(igemm_variant(x, w) == "hopper", f"[k1 guard] {name}: {igemm_variant(x, w)}")
        ref = round_bf16_64(conv64(x, w))
        shares = {k: (f(x, w).float() != ref).float().mean().item()
                  for k, f in (("hopper", conv3d_3x3_forward), ("plain", conv3d_3x3_plain))}
        ratio = shares["hopper"] / max(shares["plain"], 1e-12)
        print(f"[conv] float64 guard {name} B={BATCH} {C}->{F} @{vol} (K = {27 * C}): "
              f"rounded to another bf16 value than the float64 sum: hopper "
              f"{shares['hopper']:.3e}, plain {shares['plain']:.3e} ({ratio:.2f}x, limit "
              f"{K1_GUARD_LIMIT}x)")
        check(ratio <= K1_GUARD_LIMIT, f"[k1 guard] {name}: kernel #1's hopper variant rounds "
              f"{shares['hopper']:.3e} of the elements otherwise than float64, {ratio:.2f}x the "
              f"plain version's {shares['plain']:.3e}")
        del x, w, ref
    torch.cuda.empty_cache()
    print(f"[conv] float64 guard: {time.perf_counter() - t0:.1f} s")


def conv_phase(gen):
    """Returns max abs err, max rel err, totals for one pretraining step, for
    one inference volume and for one PlainConvUNet tile, the launch shapes it
    checked, and the timings by shape at the step's and at inference's
    batch. Ends with k1_guard."""
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
    stem_dx = (SITES[0][2], SITES[0][1], SITES[0][3])  # no path launches it: gated, not timed
    for key in shapes:
        times, (a, r), variant = time_site(*key, gen, BATCH, timed=key != stem_dx)
        if times:
            timed[key] = times
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
            if n:
                add_totals(step, n, *timed[key], *bound_ms(*key))
    volume, plain_tile = dict.fromkeys(TOTAL_KEYS, 0.0), dict.fromkeys(TOTAL_KEYS, 0.0)
    for sites, totals, n in ((INFER_SITES, volume, TILES), (PLAIN_INFER_SITES, plain_tile, 1)):
        for _, C, F, vol in sites:  # one forward a tile
            if not per_tap(vol):
                add_totals(totals, n, *infer[(C, F, vol)], *bound_ms(C, F, vol, TTA_BATCH))
    print_timed("step", BATCH, timed)
    print_timed("inference", TTA_BATCH, infer)
    k1_guard()
    checked = ({(BATCH, *vol, C, F) for C, F, vol in shapes}
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
        plain = (plain_ms(lambda: conv3d_zslab_plain(x, w))
                 + plain_ms(lambda: conv3d_zslab_plain(g, wf)))
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
            (plain_tile, plain_tile_dev), checked, timed)


def norm_act_bound_ms(batch, vol, C, skip, itemsize=2):
    """The norm epilogue's bytes over 3.35 TB/s: y (and the skip) read once,
    the output written once (its few flops an element are far below)."""
    return (3 if skip else 2) * batch * math.prod(vol) * C * itemsize / PEAK_BYTES * 1e3


def norm_act_inputs(batch, vol, C, dtype, gen):
    """y and a skip (B, X, Y, Z, C) in dtype, fp32 (B, C) a and b, fp32 (C,)
    conv and skip biases."""
    def draw(shape):
        return torch.randn(shape, generator=gen, device="cuda")
    y, skip = (2 * draw((batch, *vol, C))).to(dtype), draw((batch, *vol, C)).to(dtype)
    a = torch.rand((batch, C), generator=gen, device="cuda") + 0.5
    return y, skip, a, draw((batch, C)), draw((C,)), draw((C,))


def same_bits(got, want):
    return got.shape == want.shape and torch.equal(
        got.view(torch.int16 if got.element_size() == 2 else torch.int32),
        want.view(torch.int16 if want.element_size() == 2 else torch.int32))


# the epilogue's modes on the paths: a block's norm1 (conv1's bias,
# LeakyReLU), its norm2 (conv2's bias, the 1x1 skip conv's output and bias,
# LeakyReLU), the LightDecoder's bare norm (no bias, no activation)
NORM_ACT_MODES = {"norm1": (True, True, False), "norm2": (True, True, True),
                  "bare": (False, False, False)}


def norm_act_args(mode, y, skip, bias, skip_bias):
    """(bias, act, skip, skip_bias) of norm_act in `mode`."""
    has_bias, act, has_skip = NORM_ACT_MODES[mode]
    return ((bias if has_bias else None), act, (skip if has_skip else None),
            (skip_bias if has_skip else None))


def norm_act_phase(gen):
    """The one-pass norm epilogue at every norm shape of a volume's tile (B =
    8; norm1 and norm2 of a block) and of the pretraining step's teacher
    decoder (B = 4, bare), in bf16 and fp32: the kernel against its plain
    version, the op sequence it replaces, bit for bit with a (B, C) and a (1,
    C) affine; the moments kernel with the conv's bias against it on the
    biased tensor, bit for bit; then off the paths' shapes. In bf16 the
    kernel's time (CUDA events) beside its bound and the op sequence's time,
    and the moments kernel's with and without the bias. Returns the totals
    (TOTAL_KEYS) of a tile's 22 calls and of a step's 8."""
    shapes = {}
    for batch, norms in ((TTA_BATCH, INFER_NORMS), (BATCH, PRETRAIN_NORMS)):
        for name, vol, C, masked in norms:
            if not masked:
                mode = "bare" if batch == BATCH else name[-5:]
                shapes.setdefault((batch, vol, C), {}).setdefault(mode, []).append(name)
    timed = {}
    for (batch, vol, C), modes in shapes.items():
        for dtype in (torch.bfloat16, torch.float32):
            y, skip, a, b, bias, skip_bias = norm_act_inputs(batch, vol, C, dtype, gen)
            for mode in modes:
                args = norm_act_args(mode, y, skip, bias, skip_bias)
                for rows in (batch, 1):
                    got = norm_act(y, a[:rows], b[:rows], *args)
                    check(same_bits(got, norm_act_plain(y, a[:rows], b[:rows], *args)),
                          f"norm_act kernel vs plain B={batch} {vol} C={C} {dtype} {mode} "
                          f"affine rows {rows}: bits differ")
                    del got
            if NORM_ACT_MODES[next(iter(modes))][0]:
                with_bias = row_moments_forward(y, None, True, bias)
                biased = row_moments_forward(y + bias.to(dtype), None, True)
                check(all(same_bits(g, w) for g, w in zip(with_bias, biased)),
                      f"moments with the bias vs moments of the biased tensor B={batch} {vol} "
                      f"C={C} {dtype}: bits differ")
            if dtype == torch.bfloat16:
                for mode in modes:
                    args = norm_act_args(mode, y, skip, bias, skip_bias)
                    ms = time_ms(lambda: norm_act(y, a, b, *args), 20)
                    plain = time_ms(lambda: norm_act_plain(y, a, b, *args), 3)
                    bound = norm_act_bound_ms(batch, vol, C, args[2] is not None)
                    timed[(batch, vol, C, mode)] = (ms, plain, bound)
                    print(f"[norm_act] bf16 B={batch} {vol} C={C:<3} {mode}: {ms:.4f} ms "
                          f"({bound / ms * 100:.1f}% of the bound {bound:.4f} ms), op sequence "
                          f"{plain:.4f} ms, bit-equal in bf16 and fp32 "
                          f"({','.join(modes[mode])})")
                mom = [time_ms(lambda bi=bi: row_moments_forward(y, None, True, bi), 20)
                       for bi in (None, bias)]
                print(f"[norm_act] moments B={batch} {vol} C={C:<3}: {mom[0]:.4f} ms, with the "
                      f"conv's bias {mom[1]:.4f} ms")
            del y, skip
            torch.cuda.empty_cache()
    # off the paths: a ragged last chunk, element loads (C not a multiple of
    # 16 bytes), more columns than a block's 256 threads, STUNet-H's widths
    for batch, vol, C in ((3, (7, 9, 11), 96), (2, (5, 6, 7), 12), (1, (4, 4, 5), 2048),
                          (2, (3, 3, 3), 1536)):
        for dtype in (torch.bfloat16, torch.float32):
            y, skip, a, b, bias, skip_bias = norm_act_inputs(batch, vol, C, dtype, gen)
            for mode in NORM_ACT_MODES:
                args = norm_act_args(mode, y, skip, bias, skip_bias)
                for rows in (batch, 1):
                    check(same_bits(norm_act(y, a[:rows], b[:rows], *args),
                                    norm_act_plain(y, a[:rows], b[:rows], *args)),
                          f"norm_act kernel vs plain B={batch} {vol} C={C} {dtype} {mode}: "
                          f"bits differ")
        print(f"[norm_act] B={batch} {vol} C={C}: bit-equal in bf16 and fp32, every mode "
              f"(edge case)")

    def totals(batch, norms):
        t = dict.fromkeys(TOTAL_KEYS, 0.0)
        for name, vol, C, masked in norms:
            if not masked:
                ms, plain, bound = timed[(batch, vol, C, "bare" if batch == BATCH
                                          else name[-5:])]
                add_totals(t, 1, ms, plain, plain, 0.0, bound)
        return t

    tile, step = totals(TTA_BATCH, INFER_NORMS), totals(BATCH, PRETRAIN_NORMS)
    for label, n, t in (("tile", TILE_NORM_ACT, tile), ("step's teacher", STEP_NORM_ACT, step)):
        print(f"[norm_act] a {label} ({n} calls): {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} "
              f"ms ({t['bound_ms'] / t['ms'] * 100:.1f}%), the op sequence {t['plain_ms']:.3f} ms")
    return tile, step


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
        times = STEM_TIMES.get((batch, C, F, vol))  # the stem table timed it
    if timed and times is None:
        xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
        times = (time_ms(lambda: conv3d_zslab_forward(x, w), 3),
                 plain_ms(lambda: conv3d_zslab_plain(x, w)),
                 time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 3))
        del xc, wc
    del x, w
    torch.cuda.empty_cache()
    return abs_err, max(errs), shares, once, variant, times


# the stem variant (csrc/conv3x3_stem.cuh: bf16, C <= 8, every network's
# first conv): (path, B, (X, Y, Z), C, F, padding, timed) of each stem launch
# shape of the paths, the path naming a kernel record's by_path entry, and
# (B, (X, Y, Z), C, F, padding) of edge shapes off them: ragged extents,
# padding 0 and 2, C = 2, 5, 7, 8, F = 16, 48 and 64 (odd C with odd Z: the
# threads load the bricks; else cp.async copies them)
STEM_PATH_SHAPES = (
    ("pretrain_step", BATCH, SITES[0][3], 1, 32, 1, True),
    ("block_step", BLOCKS, (BLOCK_SITES[0][3],) * 3, 1, 32, 0, True),
    ("inference_volume", TTA_BATCH, INFER_SITES[0][3], 1, 32, 1, True),
    ("files_case", TTA_BATCH, PLAIN_INFER_SITES[0][3], PLAIN_IN, 32, 1, True),
    ("supervised_step", SUP_BATCH, INFER_SITES[0][3], 1, 32, 1, True),
    ("plain_trainer_step", SUP_BATCH, PLAIN_INFER_SITES[0][3], PLAIN_IN, 32, 1, True),
    ("cli_case", CLI_TILE_BATCH, PLAIN_INFER_SITES[0][3], 1, 32, 1, True),
    ("cascade_step", SUP_BATCH, PLAIN_INFER_SITES[0][3], CASCADE_IN, 32, 1, True),
    ("cascade_case", CLI_TILE_BATCH, PLAIN_INFER_SITES[0][3], CASCADE_IN, 32, 1, True),
    ("pretrain_h_step", H_MICRO, H_REMAT_SITES[0][3], 1, H_DIMS[0], 1, True),
    ("finetune_h_step", SUP_BATCH, H_SUP_SITES[0][3], 1, H_SUP_DIMS[0], 1, True),
    ("pretrain_h_step1", BATCH, H_REMAT_SITES[0][3], 1, H_DIMS[0], 1, False),
    ("ddp_pretrain_rank_step", 1, SITES[0][3], 1, 32, 1, False),
    ("ddp_supervised_rank_step", 1, INFER_SITES[0][3], 1, 32, 1, False))
STEM_EDGE_SHAPES = (
    (2, (7, 9, 21), 5, 48, 2), (1, (9, 10, 32), 5, 48, 2), (2, (6, 7, 24), 3, 16, 0),
    (1, (5, 13, 40), 8, 96, 1), (3, (11, 5, 16), 2, 64, 1), (2, (9, 7, 34), 1, 32, 0),
    (1, (6, 9, 20), 3, 32, 2), (1, (7, 6, 36), 7, 16, 1), (2, (5, 6, 19), 2, 16, 1))
# (B, C, F, (X, Y, Z)) -> the per-tap stem's (ms, plain ms, F.conv3d ms) at padding 1
STEM_TIMES = {}


def simple_forward(x, w, padding, per_tap=True):
    """Kernel #2's (`per_tap`) or kernel #1's simple variant at a shape the
    dispatch sends to another variant (the stem, tf32x3): the kernel that
    variant replaced, through its C entry point as launch_igemm calls it (a
    yardstick only; no launch count)."""
    B, X, Y, Z, C = x.shape
    F = w.shape[-1]
    w2 = pack_weight(w, "simple")
    y = torch.empty((B, *out_extents(x, padding), F), dtype=x.dtype, device=x.device)
    symbol = "zslab_forward" if per_tap else "conv3x3_forward"
    vec = 16 // x.element_size()
    err = conv_mod._entry("zslab_conv" if per_tap else "conv3x3", symbol, 10)(
        x.data_ptr(), w2.data_ptr(), y.data_ptr(), B, X, Y, Z, C, F, padding,
        int(x.dtype == torch.bfloat16), int(C % vec == 0 and x.data_ptr() % 16 == 0),
        int(F % vec == 0), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"{symbol} (simple) at {tuple(x.shape)} -> {F}: CUDA error {err}")
    return y


def stem_table(gen):
    """The stem variant at STEM_PATH_SHAPES and STEM_EDGE_SHAPES: kernel #2's
    per-tap forward against conv3d_zslab_plain (rel. max error <= 1e-2,
    bit-equal on >= 95%, kernel #1's one rounding at least 10 points fewer)
    and kernel #1's once-rounded forward against conv3d_3x3_plain (rel. max
    error <= 1e-2), each shape on the stem variant. At each timed path shape:
    the per-tap stem's ms beside its byte bound and share, the once-rounded
    stem's ms, both plain versions', F.conv3d's and the simple variant's (its
    C entry point, the kernel the stem replaced; held to the per-tap plain
    version, rel. max error <= 1e-2), and the stem must beat both of the last
    two. Fills STEM_TIMES; returns {kernel: (max abs, max rel)},
    the rows by path and the launch shapes checked."""
    errs = {"conv3x3": (0.0, 0.0), "zslab": (0.0, 0.0)}
    checked = {"conv3x3": set(), "zslab": set()}
    rows = {}
    for path, batch, vol, C, F, padding, timed in (
            list(STEM_PATH_SHAPES)
            + [(None, *e, False) for e in STEM_EDGE_SHAPES]):
        x, w = conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
        check(igemm_variant(x, w) == "stem", f"stem {C}->{F} @{vol}: variant {igemm_variant(x, w)}")
        y2, p2 = conv3d_zslab_forward(x, w, padding), conv3d_zslab_plain(x, w, padding)
        y1, p1 = conv3d_3x3_forward(x, w, padding), conv3d_3x3_plain(x, w, padding)
        torch.cuda.synchronize()
        r2, r1 = rel_err(y2, p2), rel_err(y1, p1)
        share, once = (y2 == p2).float().mean().item(), (y1 == p2).float().mean().item()
        a2 = (y2.float() - p2.float()).abs().max().item()
        a1 = (y1.float() - p1.float()).abs().max().item()
        # the yardstick computes the same function (its rel. max error <= 1e-2)
        r_simple = rel_err(simple_forward(x, w, padding), p2) if timed else 0.0
        del y2, p2, y1, p1
        label = f"{path or 'edge'} B={batch} {C}->{F} @{vol} p={padding}"
        check(all(math.isfinite(r) and r <= 1e-2 for r in (r2, r1, r_simple)),
              f"stem {label}: rel errors per tap {r2}, once {r1}, simple variant {r_simple}"
              f" > 1e-2")
        check(share >= 0.95 and once <= share - 0.1,
              f"stem {label}: bit-equal to plain per tap {share}, once {once}")
        errs["zslab"] = (max(errs["zslab"][0], a2), max(errs["zslab"][1], r2))
        errs["conv3x3"] = (max(errs["conv3x3"][0], a1), max(errs["conv3x3"][1], r1))
        key = (batch, *vol, C, F) + (() if padding == 1 else (padding,))
        checked["zslab"].add(key)
        checked["conv3x3"].add(key)
        line = (f"[stem] {label}: rel err per tap {r2:.3e} (bit-equal {share:.6f}), once "
                f"{r1:.3e} (bit-equal to per tap {once:.6f})")
        if timed:
            xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
            ms = time_ms(lambda: conv3d_zslab_forward(x, w, padding), 3)
            ms_once = time_ms(lambda: conv3d_3x3_forward(x, w, padding), 3)
            simple = time_ms(lambda: simple_forward(x, w, padding), 1)
            plain = plain_ms(lambda: conv3d_zslab_plain(x, w, padding))
            plain_once = plain_ms(lambda: conv3d_3x3_plain(x, w, padding))
            lib = time_ms(lambda: fn.conv3d(xc, wc, None, 1, padding), 3)
            del xc, wc
            flop_ms, byte_ms = bound_ms(C, F, vol, batch, padding=padding)
            bound = max(flop_ms, byte_ms)
            rows[path] = dict(batch=batch, C=C, F=F, vol=list(vol), padding=padding, ms=ms,
                              once_ms=ms_once, bound_ms=bound,
                              bound_by="operations" if flop_ms >= byte_ms else "bytes",
                              share=bound / ms, plain_ms=plain, once_plain_ms=plain_once,
                              library_ms=lib, simple_ms=simple)
            if padding == 1:
                STEM_TIMES[(batch, C, F, vol)] = (ms, plain, lib)
            line += (f"; {ms:.4f} ms per tap, {ms_once:.4f} ms once; bound {bound:.4f} ms "
                     f"({rows[path]['bound_by']}), {bound / ms:.1%} of it; plain {plain:.3f} ms "
                     f"(once {plain_once:.3f} ms), "
                     f"F.conv3d {lib:.4f} ms, simple variant {simple:.4f} ms (rel err "
                     f"{r_simple:.3e})")
            check(ms < lib and ms < simple, f"stem {label}: {ms} ms, not below F.conv3d's "
                                           f"{lib} ms and the simple variant's {simple} ms")
        print(line)
        del x, w
        torch.cuda.empty_cache()
    return errs, rows, checked


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
    return max_abs, max_rel, step, volume, plain_tile, checked, timed


class LaunchShapes:
    """Records the shape of every kernel launch while it is on: each conv's
    (B, X, Y, Z, C, F) at padding 1, (B, X, Y, Z, C, F, padding) at 0 or 2
    (the block-sparse route; X, Y, Z the input's), "fp32" after either in
    float32 (the tf32x3 and simple variants' shapes), and the moments' (B, X,
    Y, Z, C, masked, square_in_dtype). It wraps each module's launch function and leaves the
    launch counts to the wrappers; `paused` is a stretch whose launches (a
    gate's, inside a path's phase) it does not record."""

    def __init__(self):
        self.conv, self.zslab, self.moments = set(), set(), set()
        self.on = True
        conv_launch, zslab_launch = conv_mod._launch, zslab_mod._launch
        moments_launch = moments_mod._launch

        def key(x, w, padding):
            return ((*x.shape, w.shape[-1]) + (() if padding == 1 else (padding,))
                    + (("fp32",) if x.dtype == torch.float32 else ()))

        def conv(x, w, padding):
            if self.on:
                self.conv.add(key(x, w, padding))
            return conv_launch(x, w, padding)

        def zslab(x, w, padding):
            if self.on:
                self.zslab.add(key(x, w, padding))
            return zslab_launch(x, w, padding)

        def moments(x, mask, square_in_dtype, bias=None):
            if self.on:
                self.moments.add((*x.shape, mask is not None, square_in_dtype))
            return moments_launch(x, mask, square_in_dtype, bias)

        conv_mod._launch, zslab_mod._launch, moments_mod._launch = conv, zslab, moments

    @contextmanager
    def paused(self):
        self.on = False
        try:
            yield
        finally:
            self.on = True


def fp32_launches(path):
    """(kernel, C, F, (X, Y, Z), launches a step or volume) of each fp32
    launch shape of `path` ("pretrain_step": two forwards at B = 4 and the
    student's dx but at the stem; "inference_volume": 18 tiles of one
    forward at B = 8)."""
    sites, n, dx = ((SITES, 2, True) if path == "pretrain_step" else (INFER_SITES, TILES, False))
    out = {}
    for i, (_, C, F, vol) in enumerate(sites):
        key = ("zslab" if per_tap(vol) else "conv3x3", C, F, vol)
        out[key] = out.get(key, 0) + n
        if dx and i > 0:  # the stem's input carries no gradient
            out[("conv3x3", F, C, vol)] = out.get(("conv3x3", F, C, vol), 0) + 1
    return out


FP32_PATHS = {"pretrain_step": BATCH, "inference_volume": TTA_BATCH}  # path -> batch
# fp32 stems that no card path launches yet but that users reach with
# -compute_dtype float32, gated and timed as the paths' stems: (label, B, C,
# F, (X, Y, Z)) of predict's tile on BraTS-like data (C = 4), the cascade's
# tile (C = 3) and STUNet-H's stem (1 -> 96), each kernel #2's (>= MIN_VOLUME
# voxels a sample)
FP32_STEM_SHAPES = (("files_tile", TTA_BATCH, PLAIN_IN, 32, (128,) * 3),
                    ("cascade_tile", CLI_TILE_BATCH, CASCADE_IN, 32, (128,) * 3),
                    ("pretrain_h_step", H_MICRO, 1, H_DIMS[0], H_RES[0]))


def fp32_gate_phase(gen):
    """The float32 path's launch shapes (fp32_launches of the B step and of a
    volume) and FP32_STEM_SHAPES on the card: each kernel's forward against
    its plain version (rel. max error <= 1e-5) on the variant the rule picks
    (tf32x3; the stems stem, where kernel #1's once-rounded stem is gated
    and timed too), then its time beside the simple variant's at the same
    shape (its C entry point: the kernel tf32x3 and the stem replaced), the
    plain version's (the gate's call), F.conv3d's in fp32 with TF32 off (a
    yardstick; each time_ms of single calls) and the bound (bound_ms's
    3xTF32 form, or the bytes; the FP32 pipe's time beside it). Returns
    {kernel: (max abs, max rel)} ("stem": kernel #2's fp32 stem, "stem_once":
    kernel #1's, apart from the tf32x3 launches'), the times {(path, kernel,
    C, F, vol): (ms, plain ms, F.conv3d ms, simple ms)}, the stems' rows by
    path and the launch shapes checked (LaunchShapes' form)."""
    check_tf32_off("the fp32 gates' F.conv3d yardstick")
    t0 = time.perf_counter()
    errs = dict.fromkeys(("conv3x3", "zslab", "stem", "stem_once"), (0.0, 0.0))
    checked = {"conv3x3": set(), "zslab": set()}
    times, rows = {}, {}
    shapes = ([(path, batch, *launch) for path, batch in FP32_PATHS.items()
               for launch in fp32_launches(path)]
              + [(label, batch, "zslab", C, F, vol) for label, batch, C, F, vol in FP32_STEM_SHAPES])

    def gate(fwd, plain, x, w, label):
        """fwd against plain (<= 1e-5): (max abs err, rel err, plain ms)."""
        y_k = fwd(x, w)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        y_p = plain(x, w)  # the plain version's time: this call's
        events[1].record()
        torch.cuda.synchronize()
        r = rel_err(y_k, y_p)
        a = (y_k - y_p).abs().max().item()
        check(math.isfinite(r) and r <= 1e-5, f"[fp32] {label}: rel error {r} > 1e-5")
        return a, r, events[0].elapsed_time(events[1])

    for path, batch, kernel, C, F, vol in shapes:
        x, w = conv_inputs(C, F, vol, batch, torch.float32, gen)
        per = kernel == "zslab"
        fwd, plain = ((conv3d_zslab_forward, conv3d_zslab_plain) if per
                      else (conv3d_3x3_forward, conv3d_3x3_plain))
        variant = igemm_variant(x, w)
        label = f"{path} kernel #{2 if per else 1} B={batch} {C:>4}->{F:<4} @{vol}"
        check(variant == conv_variant(torch.float32, C, F)
              and variant == ("stem" if C <= STEM_MAX_C else "tf32x3"),
              f"[fp32] {label}: variant {variant}")
        a, r, plain_t = gate(fwd, plain, x, w, label)
        key = "stem" if variant == "stem" else kernel
        errs[key] = (max(errs[key][0], a), max(errs[key][1], r))
        checked[kernel].add((batch, *vol, C, F, "fp32"))
        xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
        ms = time_ms(lambda: fwd(x, w), 1)
        simple = time_ms(lambda: simple_forward(x, w, 1, per), 1)
        lib = time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 1)
        times[(path, kernel, C, F, vol)] = (ms, plain_t, lib, simple)
        flop_ms, byte_ms = bound_ms(C, F, vol, batch, itemsize=4)
        bound = max(flop_ms, byte_ms)
        by = "operations" if flop_ms >= byte_ms else "bytes"
        pipe = fp32_pipe_ms(C, F, vol, batch)
        line = (f"[fp32] {label} ({variant}): rel err {r:.3e}; {ms:.3f} ms "
                f"({conv_flops(C, F, vol, batch) / ms / 1e9:.1f} TFLOP/s), bound {bound:.3f} ms "
                f"({by}, 3xTF32), {bound / ms:.1%} of it, FP32 pipe {pipe:.3f} ms; simple "
                f"{simple:.3f} ms, plain {plain_t:.3f} ms, F.conv3d (TF32 off) {lib:.3f} ms")
        if variant == "stem":  # kernel #1's stem, rounded once, at the same shape
            a1, r1, plain1 = gate(conv3d_3x3_forward, conv3d_3x3_plain, x, w,
                                  f"{label} kernel #1")
            errs["stem_once"] = (max(errs["stem_once"][0], a1), max(errs["stem_once"][1], r1))
            once = time_ms(lambda: conv3d_3x3_forward(x, w), 1)
            checked["conv3x3"].add((batch, *vol, C, F, "fp32"))
            rows[path] = dict(batch=batch, C=C, F=F, vol=list(vol), ms=ms, once_ms=once,
                              bound_ms=bound, bound_by=by, share=bound / ms, pipe_ms=pipe,
                              plain_ms=plain_t, once_plain_ms=plain1, library_ms=lib,
                              simple_ms=simple)
            line += (f"; kernel #1's stem {once:.3f} ms (rel err {r1:.3e}, plain "
                     f"{plain1:.3f} ms)")
        del x, w, xc, wc
        torch.cuda.empty_cache()
        print(line)
    print(f"[fp32] gates: {time.perf_counter() - t0:.1f} s")
    return errs, times, rows, checked


FP32_KEYS = TOTAL_KEYS + ("simple_ms", "pipe_ms")


def fp32_totals(times):
    """{(path, kernel): FP32_KEYS totals of one B step or one volume} over the
    launches the tf32x3 variant runs, and over the stems' (the stem variant,
    under (path, "stem")), from fp32_gate_phase's times."""
    tot = {}
    for path, batch in FP32_PATHS.items():
        for (kernel, C, F, vol), n in fp32_launches(path).items():
            ms, plain, lib, simple = times[(path, kernel, C, F, vol)]
            t = tot.setdefault((path, "stem" if C <= STEM_MAX_C else kernel),
                               dict.fromkeys(FP32_KEYS, 0.0))
            add_totals(t, n, ms, plain, lib, *bound_ms(C, F, vol, batch, itemsize=4))
            t["simple_ms"] += n * simple
            t["pipe_ms"] += n * fp32_pipe_ms(C, F, vol, batch)
    for (path, kernel), t in tot.items():
        print(f"[fp32] {path} {kernel} total: {t['ms']:.3f} ms, simple {t['simple_ms']:.3f} ms "
              f"({t['simple_ms'] / t['ms']:.2f}x), F.conv3d (TF32 off) {t['library_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.3f} ms (3xTF32; FP32 pipe {t['pipe_ms']:.3f}), plain "
              f"{t['plain_ms']:.3f} ms")
    return tot


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


def tf32_defaults():
    """PyTorch's default TF32 flags: cuDNN's float32 convolutions in TF32,
    cuBLAS's float32 matmuls not."""
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False


def check_tf32_off(what):
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          f"{what} left TF32 on (cuDNN {torch.backends.cudnn.allow_tf32}, cuBLAS "
          f"{torch.backends.cuda.matmul.allow_tf32})")


def tf32_gap(student, teacher, x, len_loss, gen):
    """What the port's TF32 repair changes in the fp32 step: the step's first
    step run on copies of its weights and draws (a fresh optimizer, as the
    step's), once with PyTorch's default flags set back (cuDNN in TF32) and
    once as the port runs it (TF32 off). Returns a function that, given the
    real first step's loss and student, prints each copy's relative
    distance from it: the loss's, and the clipped gradients' (the
    largest difference over all leaves against the largest gradient). The
    TF32 copy's is the fault's size, the other's the run-to-run spread
    (cuDNN's atomics in dw). Fails on a non-finite distance."""
    copies = {}
    state = gen.get_state()
    for label, tf32 in (("cuDNN in TF32 (PyTorch's default)", True), ("TF32 off, again", False)):
        s, t = copy.deepcopy(student), copy.deepcopy(teacher)
        g = torch.Generator(device="cuda")
        g.set_state(state)
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            loss, _, _ = anatomask_train_step(s, t, make_optimizer(s), x, len_loss, g)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        copies[label] = (loss.item(), [p.grad.detach().clone() for p in s.parameters()])
        del s, t
    free_memory()

    def gap(loss, model):
        ref = [p.grad.detach() for p in model.parameters()]
        scale = max(g.abs().max().item() for g in ref)
        out = {label: (abs(v - loss.item()) / abs(loss.item()),
                       max((a - b).abs().max().item() for a, b in zip(grads, ref)) / scale)
               for label, (v, grads) in copies.items()}
        print("[fp32 step] the first step against copies of it: " + "; ".join(
            f"{label}: loss {d_loss:.3e} relative, gradients {d_grad:.3e} of the largest"
            for label, (d_loss, d_grad) in out.items()))
        check(all(math.isfinite(v) for d in out.values() for v in d), f"TF32 gaps {out}")

    return gap


def slice_phase(block=False, dtype="bfloat16"):
    """5 AnatoMask steps at full STUNet-B width, the dense route or with
    `block` the block-sparse one (ATK_BLOCK_SPARSE=1 set by the caller), from
    the same seeded weights and draws, in `dtype` (float32: the model built
    after PyTorch's default TF32 flags are set back, which the port's setup
    must turn off; then tf32_gap on the first step). Returns the launches of
    the 5 steps, the step ms (median of steps 3-5), the peak memory and the
    losses."""
    fp32 = dtype == "float32"
    tag = "[block]" if block else "[fp32 step]" if fp32 else "[slice]"
    want_pads = BLOCK_STEP_PADDINGS if block else STEP_PADDINGS
    want_launches = FP32_STEP_LAUNCHES if fp32 else STEP_LAUNCHES
    cfg = PretrainConfig(compute_dtype=dtype)
    if fp32:
        tf32_defaults()
    student = build_spark_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    if fp32:
        check_tf32_off(f"{tag} build_spark_model")
    teacher = make_teacher(student)
    optimizer = make_optimizer(student)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((BATCH, 1, *cfg.patch_size), generator=gen, device="cuda")
    x = x.to(student.dtype).contiguous(memory_format=torch.channels_last_3d)
    L = math.prod(student.fmap)
    len_loss = int((L - student.len_keep) * 0.25)
    check(student.fmap == FMAP and student.len_keep == LEN_KEEP and len_loss == 58,
          f"main-path sizes {student.fmap} {student.len_keep} {len_loss}")
    n_params = sum(p.numel() for p in student.parameters())
    encoder = student.sparse_encoder.sp_cnn
    n_block = encoder._block_stage_count(x, torch.ones((1, 1, *FMAP), dtype=torch.bool))
    check(n_block == (2 if block else 0), f"{tag} block-sparse stages {n_block}")
    print(f"{tag} STUNet-B SparK, {n_params} parameters, patch {cfg.patch_size}, "
          f"batch {BATCH}, {dtype}; fmap {student.fmap}, keep {student.len_keep}, "
          f"forced {len_loss}, block-sparse stages {n_block}")
    gap = tf32_gap(student, teacher, x, len_loss, gen) if fp32 else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    # counts from here on belong to the pretraining path
    zero_counts()
    for step in range(STEPS):
        before, pads, act_before = counts(), padding_counts(), norm_act.launches
        old = [p.detach().clone() for p in teacher.parameters()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, hard, loss_map = anatomask_train_step(student, teacher, optimizer, x,
                                                    len_loss, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if gap is not None and step == 0:
            gap(loss, student)
        losses.append(loss.item())
        check(math.isfinite(losses[-1]), f"step {step}: loss {losses[-1]}")
        hard = hard.reshape(BATCH, L)
        check(hard.sum(1).tolist() == [student.len_keep] * BATCH,
              f"step {step}: kept {hard.sum(1).tolist()}")
        top = torch.topk(loss_map, len_loss, dim=1).indices
        check(not torch.gather(hard, 1, top).any(), f"step {step}: a forced patch is kept")
        # two forwards (teacher, student) of 17 convs and 22 norms and the
        # student's dx: 34 on kernel #1, all hopper (fp32: tf32x3); 16 on
        # kernel #2, of which the stem's two (C = 1) on the stem variant (in
        # fp32 too); 44 moments
        n = since(before)
        check(n == want_launches, f"{tag} step {step}: launches {n}, expected {want_launches}")
        n_act = norm_act.launches - act_before
        check(n_act == STEP_NORM_ACT, f"{tag} step {step}: {n_act} norm epilogue launches, "
              f"expected {STEP_NORM_ACT} (the teacher's decoder)")
        n_pad = {k: v - pads[k] for k, v in padding_counts().items()}
        check(n_pad == want_pads, f"{tag} step {step}: launches by padding {n_pad}, "
              f"expected {want_pads}")
        moved = False
        for e, o, p in zip(teacher.parameters(), old, student.parameters()):
            want = o + 0.001 * (p.detach() - o)
            check((e - want).abs().max().item() <= 1e-6, f"step {step}: EMA law broken")
            moved = moved or not torch.equal(e, o)
        check(moved, f"step {step}: the teacher did not move")
        print(f"{tag} step {step}: loss {losses[-1]:.6f}, {times[-1]:.1f} ms, launches {n}"
              f"{f', by padding {n_pad}' if block else ''}")
    launches = counts()
    step_ms = statistics.median(times[WARMUP:])
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} step {step_ms:.1f} ms (median of {STEPS - WARMUP}), "
          f"{BATCH / step_ms * 1e3:.3f} patches/s, peak memory {peak / 2**30:.2f} GiB "
          f"({peak} bytes), launches in {STEPS} steps {launches}")
    for _ in range(EXTRA_STEPS):
        anatomask_train_step(student, teacher, optimizer, x, len_loss, gen)
    return launches, step_ms, peak, losses


def block_flops(C, F, e_in, e_out, batch=BLOCKS):
    """The operations one padded 3x3x3 conv of `batch` blocks of e_in^3 into
    e_out^3 voxels needs: those of the VALID conv between the two, 27 taps
    for each of the min(e_in, e_out)^3 voxels (the dx at padding 2 is the
    forward at padding 0 transposed; its other taps read the padding)."""
    return 2 * batch * min(e_in, e_out) ** 3 * 27 * C * F


def block_bound_ms(C, F, e_in, e_out, batch=BLOCKS):
    """(FLOP ms, byte ms) of one padded 3x3x3 conv of `batch` blocks of e_in^3
    into e_out^3 voxels."""
    n_in, n_out = batch * e_in ** 3, batch * e_out ** 3
    flops = block_flops(C, F, e_in, e_out, batch)
    nbytes = (n_in * C + 27 * C * F + n_out * F) * 2
    return flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def block_site(C, F, e, gen):
    """Kernel #2 at padding 0 on BLOCKS halo'd blocks of e^3 and, for C > 1,
    dx through conv3d_zconcat (kernel #1 at padding 2) against the plain
    versions, with zconcat_site's gates (rel. max error <= 1e-2, bit-equal
    on >= 95%, kernel #1's one rounding at least 10 points fewer on the
    forward); then the times of each beside the plain version's and
    F.conv3d's at the same padding. Returns max abs err, max rel err, the
    variant and {"fwd": (ms, plain, lib)[, "dx": ...]}."""
    x, w = conv_inputs(C, F, (e,) * 3, BLOCKS, torch.bfloat16, gen)
    variant = igemm_variant(x, w)
    y_k, y_p = conv3d_zslab_forward(x, w, 0), conv3d_zslab_plain(x, w, 0)
    once = (conv3d_3x3_forward(x, w, 0) == y_p).float().mean().item()
    errs, shares = [rel_err(y_k, y_p)], [(y_k == y_p).float().mean().item()]
    abs_err = (y_k.float() - y_p.float()).abs().max().item()
    del y_k, y_p
    xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
    times = {"fwd": (time_ms(lambda: conv3d_zslab_forward(x, w, 0), 3),
                     plain_ms(lambda: conv3d_zslab_plain(x, w, 0)),
                     time_ms(lambda: fn.conv3d(xc, wc, None, 1, 0), 3))}
    if C > 1:
        g = torch.randn((BLOCKS, *(e - 2,) * 3, F), generator=gen, device="cuda").to(torch.bfloat16)
        xg = x.detach().requires_grad_(True)
        dx_k, = torch.autograd.grad(conv3d_zconcat(xg, w, 0), xg, g)
        wf = flip_weight(w)
        dx_p = conv3d_3x3_plain(g, wf, 2)
        errs.append(rel_err(dx_k, dx_p))
        shares.append((dx_k == dx_p).float().mean().item())
        abs_err = max(abs_err, (dx_k.float() - dx_p.float()).abs().max().item())
        del xg, dx_k, dx_p
        gc_, wfc = g.permute(0, 4, 1, 2, 3), wf.permute(4, 3, 0, 1, 2).contiguous()
        times["dx"] = (time_ms(lambda: conv3d_3x3_forward(g, wf, 2), 3),
                       plain_ms(lambda: conv3d_3x3_plain(g, wf, 2)),
                       time_ms(lambda: fn.conv3d(gc_, wfc, None, 1, 2), 3))
    torch.cuda.synchronize()
    check(all(math.isfinite(e_) and e_ <= 1e-2 for e_ in errs),
          f"block {C}->{F} @{e}^3: rel errors (fwd, dx) {errs} > 1e-2")
    check(min(shares) >= 0.95 and once <= shares[0] - 0.1,
          f"block {C}->{F} @{e}^3: bit-equal shares (fwd, dx) {shares}, kernel #1 fwd {once}")
    print(f"[block] kernel #2 p=0 {C:>2}->{F:<2} {BLOCKS} x {e}^3 ({variant}): rel err "
          f"{max(errs):.3e}, bit-equal to plain fwd {shares[0]:.6f}"
          f"{f', dx (kernel #1 p=2) {shares[1]:.6f}' if C > 1 else ''}, kernel #1 fwd {once:.6f}")
    torch.cuda.empty_cache()
    return abs_err, max(errs), variant, times


def block_gate_phase(gen):
    """The block-sparse route's kernel launches held against the plain
    versions at every shape of its step: kernel #2 at padding 0 and kernel #1
    at padding 2 (block_site), bf16 off-path shapes at both paddings on both
    kernels (ragged M, BN = 32; <= 1e-2), fp32 ones (<= 1e-5), and the block
    norms' moments (bf16 and fp32, with and without square_in_dtype; <= 1e-5,
    two calls bit-equal). Prints each block launch's time beside its bound,
    the plain version's and the library call's. Returns {kernel: (max abs,
    max rel)}, the times by block site and norm, and the checked shapes."""
    errs = {"conv3x3": (0.0, 0.0), "zslab": (0.0, 0.0), "moments": (0.0, 0.0)}
    checked = {"conv3x3": set(), "zslab": set(), "moments": set()}

    def worst(kernel, a, r):
        errs[kernel] = (max(errs[kernel][0], a), max(errs[kernel][1], r))

    sites = {}
    for name, C, F, e in BLOCK_SITES:
        a, r, variant, times = block_site(C, F, e, gen)
        worst("zslab", a, r)
        if C > 1:
            worst("conv3x3", a, r)
            checked["conv3x3"].add((BLOCKS, *(e - 2,) * 3, F, C, 2))
        checked["zslab"].add((BLOCKS, *(e,) * 3, C, F, 0))
        sites[name] = times
        for part, (ms, plain, lib) in times.items():
            c_in, c_out, e_in, e_out = (C, F, e, e - 2) if part == "fwd" else (F, C, e - 2, e)
            flop_ms, byte_ms = block_bound_ms(c_in, c_out, e_in, e_out)
            tflops = block_flops(c_in, c_out, e_in, e_out) / ms / 1e9
            kernel = "kernel #2 p=0" if part == "fwd" else "kernel #1 p=2"
            by = "operations" if flop_ms >= byte_ms else "bytes"
            print(f"[block] {name} {part} ({kernel}) {c_in}->{c_out} {e_in}^3 -> {e_out}^3: "
                  f"{ms:.3f} ms ({tflops:.1f} TFLOP/s), bound {max(flop_ms, byte_ms):.3f} ms "
                  f"({by}), plain {plain:.3f} ms, F.conv3d {lib:.3f} ms")
    # (B, vol, C, F): ragged M with BN = 32 (F = 96, 160) in bf16; the simple
    # variant's fp32 at C = 32, the C = 1 stem and C != F over one N tile
    edge = ((torch.bfloat16, 1e-2, ((5, (7, 9, 11), 64, 96), (3, (10, 10, 10), 32, 160))),
            (torch.float32, 1e-5, ((2, (10, 11, 12), 32, 32), (2, (9, 9, 9), 1, 32),
                                   (3, (6, 7, 8), 48, 80))))
    for dtype, tol, shapes in edge:
        for batch, vol, C, F in shapes:
            x, w = conv_inputs(C, F, vol, batch, dtype, gen)
            for padding in (0, 2):
                for label, kern, plain_fn in (("conv3x3", conv3d_3x3_forward, conv3d_3x3_plain),
                                              ("zslab", conv3d_zslab_forward, conv3d_zslab_plain)):
                    y_k, y_p = kern(x, w, padding), plain_fn(x, w, padding)
                    r = rel_err(y_k, y_p)
                    check(math.isfinite(r) and r <= tol, f"{label} p={padding} {C}->{F} @{vol} "
                          f"B={batch} {dtype}: rel error {r} > {tol}")
                    worst(label, (y_k.float() - y_p.float()).abs().max().item(), r)
            print(f"[block] {str(dtype)[6:]} B={batch} {C}->{F} @{vol} ({igemm_variant(x, w)}): "
                  f"both kernels at p=0 and p=2 within {tol} of the plain versions")
    norms = {}
    for bs, C in sorted({(bs, C) for _, bs, C in BLOCK_NORMS}):
        vol = (LEN_KEEP * bs, bs, bs)
        for dtype in (torch.bfloat16, torch.float32):
            x, _ = moments_inputs(BATCH, vol, C, False, dtype, gen)
            for square in (False, True):
                a, r = moments_err(x, None, square)
                check(math.isfinite(r) and r <= 1e-5, f"block moments {vol} C={C} {dtype} "
                      f"square_in_dtype={square}: rel error {r} > 1e-5")
                worst("moments", a, r)
            if dtype == torch.bfloat16:
                ms = time_ms(lambda: row_moments_forward(x, None, False), 20)
                plain = time_ms(lambda: row_moments_plain(x, None, False), 3)
                lib = time_ms(lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0), 5)
                visible = BATCH * math.prod(vol)
                norms[(bs, C)] = (ms, plain, lib, moments_bound_ms(BATCH, vol, C, False, visible))
                flop_ms, byte_ms = norms[(bs, C)][3]
                print(f"[block] moments B={BATCH} {vol} C={C}, no mask, square_in_dtype=0: "
                      f"{ms:.4f} ms, bound {max(flop_ms, byte_ms):.4f} ms, plain {plain:.4f} ms, "
                      f"var_mean {lib:.4f} ms; bf16 and fp32 within 1e-5, two calls bit-equal")
        checked["moments"].add((BATCH, *vol, C, False, False))
        torch.cuda.empty_cache()
    return errs, (sites, norms), checked


def block_step_totals(k1_step, zc_timed, mom_timed, block):
    """One block step's TOTAL_KEYS totals a kernel: the dense step's
    launches (conv_phase, zconcat_phase, moments_phase times) with the block
    sites' and norms' in place of the dense ones they replace."""
    sites, norms = block
    replaced = {name for name, *_ in BLOCK_SITES}
    totals = {k: dict.fromkeys(TOTAL_KEYS, 0.0) for k in ("conv3x3", "zslab", "moments")}
    for name, C, F, vol in SITES:
        if per_tap(vol) and name not in replaced:
            add_totals(totals["zslab"], 2, *zc_timed[(BATCH, C, F, vol)], *bound_ms(C, F, vol))
        elif not per_tap(vol):
            add_totals(totals["conv3x3"], 2, *k1_step[(C, F, vol)], *bound_ms(C, F, vol))
        if name not in replaced:  # the dx of every conv but the stem and the block sites'
            add_totals(totals["conv3x3"], 1, *k1_step[(F, C, vol)], *bound_ms(F, C, vol))
    for name, C, F, e in BLOCK_SITES:
        add_totals(totals["zslab"], 2, *sites[name]["fwd"], *block_bound_ms(C, F, e, e - 2))
        if "dx" in sites[name]:
            add_totals(totals["conv3x3"], 1, *sites[name]["dx"], *block_bound_ms(F, C, e - 2, e))
    block_norms = {name for name, *_ in BLOCK_NORMS}
    for name, vol, C, masked in PRETRAIN_NORMS:
        if name not in block_norms:
            ms, plain, lib, visible = mom_timed[(BATCH, vol, C, masked)]
            add_totals(totals["moments"], 2, ms[1], plain, lib,
                       *moments_bound_ms(BATCH, vol, C, masked, visible))
    for _, bs, C in BLOCK_NORMS:
        ms, plain, lib, bounds = norms[(bs, C)]
        add_totals(totals["moments"], 2, ms, plain, lib, *bounds)
    for kernel, t in totals.items():
        print(f"[block] step {kernel}: {t['ms']:.3f} ms, bound {t['bound_ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms")
    return totals


def block_step_phase(dense_step_ms, dense_losses, shapes):
    """The block-sparse route at full width: the STUNet-B encoder in fp32
    with ATK_BLOCK_SPARSE=1 against without it on one masked batch (every
    feature within 1e-5 of its largest entry), two backward passes of it in
    bf16 through the route (bit-equal gradients), then slice_phase's 5
    AnatoMask steps with it (launches by kernel and variant as a dense
    step's, by padding BLOCK_STEP_PADDINGS), printed beside the dense step
    of this process. Returns the launches, step ms, peak memory."""
    os.environ["ATK_BLOCK_SPARSE"] = "1"
    os.environ.pop("ATK_BLOCK_SPARSE_STAGES", None)
    try:
        gen = torch.Generator(device="cuda").manual_seed(4)
        enc = SparseSTUNetEncoder(1, (32, 64, 128, 256, 512), torch.float32,
                                  torch.Generator().manual_seed(3), len_keep=LEN_KEEP).to("cuda")
        keep = random_keep_mask(BATCH, FMAP, LEN_KEEP, gen)
        x = torch.rand((BATCH, 1, *PretrainConfig().patch_size), generator=gen, device="cuda")
        x = (x * upsample_mask(keep, (16, 16, 16))).contiguous(memory_format=torch.channels_last_3d)
        check(enc._block_stage_count(x, keep) == 2, "the encoder does not take the block route")
        with shapes.paused(), torch.no_grad():  # fp32: a check, not the path
            before = padding_counts()
            got = enc(x, keep)
            torch.cuda.synchronize()
            pads = {k: v - before[k] for k, v in padding_counts().items()}
            os.environ["ATK_BLOCK_SPARSE"] = "0"
            want = enc(x, keep)
            os.environ["ATK_BLOCK_SPARSE"] = "1"
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        check(pads["zslab.p0"] == 3 and all(math.isfinite(e) and e <= 1e-5 for e in errs),
              f"block encoder fp32 vs dense: rel errors {errs}, launches by padding {pads}")
        print(f"[block] STUNet-B encoder fp32, B={BATCH}, keep {LEN_KEEP}: block route vs dense, "
              f"rel err by feature {', '.join(f'{e:.3e}' for e in errs)}; launches by padding "
              f"{pads}")
        del enc, got, want
        # two backward passes through the route in bf16, the step's dtype, with
        # cuDNN held to its deterministic algorithms: the same bits (the halo's
        # backward gathers; it has no atomics)
        enc = SparseSTUNetEncoder(1, (32, 64, 128, 256, 512), torch.bfloat16,
                                  torch.Generator().manual_seed(3), len_keep=LEN_KEEP).to("cuda")
        saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        grads = []
        try:
            with shapes.paused():
                for _ in range(2):
                    enc.zero_grad(set_to_none=True)
                    sum(f.float().square().mean() for f in enc(x, keep)).backward()
                    grads.append([p.grad.clone() for p in enc.parameters()])
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        check(all(torch.equal(a, b) for a, b in zip(*grads)),
              "block route: two bf16 backward passes gave different gradients")
        print(f"[block] STUNet-B encoder bf16: two backward passes through the route, gradients "
              f"bit-equal over {len(grads[0])} leaves")
        del enc, grads, x
        free_memory()
        launches, step_ms, peak, losses = slice_phase(block=True)
    finally:
        os.environ.pop("ATK_BLOCK_SPARSE", None)
    print(f"[block] step {step_ms:.1f} ms against the dense step's {dense_step_ms:.1f} ms "
          f"({step_ms / dense_step_ms:.4f}x), {BATCH / step_ms * 1e3:.3f} patches/s, peak "
          f"{peak / 2**30:.2f} GiB; first loss {losses[0]:.6f} against the dense route's "
          f"{dense_losses[0]:.6f} (same weights and draws)")
    return launches, step_ms, peak


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


def inference_phase(dtype=torch.bfloat16, volumes=VOLUMES):
    """bench_inference.py's configuration through the Predictor, in `dtype`
    (float32: `predict -compute_dtype float32`, the Predictor built after
    PyTorch's default TF32 flags are set back; its setup must turn them
    off), `volumes` volumes, the first a warm-up where there are more."""
    fp32 = dtype == torch.float32
    tag = "[fp32 volume]" if fp32 else "[inference]"
    want_tile = FP32_TILE_LAUNCHES if fp32 else TILE_LAUNCHES
    plans = {"dataset_name": "Dataset000_BraTSLike", "plans_name": "chipSmokePlans",
             "configurations": {"3d_fullres": {
                 "patch_size": list(PATCH), "UNet_class_name": "STUNet-B",
                 "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 5,
                 "conv_kernel_sizes": [[3, 3, 3]] * 6}}}
    dataset_json = {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "MR"}}
    pm = PlansManager(plans)
    cm = pm.get_configuration("3d_fullres")
    net = build_network_from_plans(pm, cm, 1, NUM_CLASSES, deep_supervision=False,
                                   dtype=dtype, device="cuda",
                                   generator=torch.Generator().manual_seed(0))
    if fp32:
        tf32_defaults()
    predictor = Predictor(tile_step_size=0.5, use_mirroring=True, tile_batch_size=1,
                          dtype=dtype, device="cuda")
    if fp32:
        check_tf32_off(f"{tag} Predictor(dtype=torch.float32)")
    predictor.manual_initialization(net, pm, cm, [net.state_dict()], dataset_json, (0, 1, 2))
    tiles = math.prod(len(s) for s in compute_steps_for_sliding_window(VOLUME, PATCH, 0.5))
    check(tiles == TILES, f"{tiles} tiles, expected {TILES}")
    n_params = sum(p.numel() for p in net.parameters())
    print(f"{tag} STUNet-B, {n_params} parameters, volume {VOLUME}, patch {PATCH}, "
          f"{tiles} tiles, 8-flip TTA, tile batch 1, {str(dtype)[6:]}")
    data = np.random.RandomState(0).rand(1, *VOLUME).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, first = [], None
    # counts from here on belong to the inference path
    zero_counts()
    for v in range(volumes):
        before, act_before = counts(), norm_act.launches
        t0 = time.perf_counter()
        logits = predictor.predict_sliding_window_return_logits(data)
        times.append(time.perf_counter() - t0)
        n = since(before)
        n_act = norm_act.launches - act_before
        check(n_act == TILES * TILE_NORM_ACT, f"{tag} volume {v}: {n_act} norm epilogue "
              f"launches, expected {TILES * TILE_NORM_ACT} ({TILE_NORM_ACT} a tile)")
        check(logits.shape == (NUM_CLASSES, *VOLUME), f"volume {v}: logits {logits.shape}")
        check(bool(np.isfinite(logits).all()), f"volume {v}: non-finite logits")
        # a tile: 7 convs on kernel #1, 10 on kernel #2 (the stem on the stem
        # variant, in fp32 too; fp32: the rest tf32x3), 22 norms
        want = {k: TILES * n_tile for k, n_tile in want_tile.items()}
        check(n == want, f"{tag} volume {v}: launches {n}, expected {want}")
        first = logits if first is None else first
        print(f"{tag} volume {v}: {times[-1]:.3f} s, launches {n}, norm epilogue {n_act}, "
              f"logits mean {float(logits.mean()):.6f}, max |diff| to volume 0 "
              f"{float(np.abs(logits - first).max()):.3e}")
    launches = counts()
    volume_s = statistics.median(times[1:] or times)
    peak = torch.cuda.max_memory_allocated()
    print(f"{tag} {volume_s:.3f} s a volume (median of {max(1, volumes - 1)}), "
          f"{1 / volume_s:.4f} volumes/s, {TILES / volume_s:.2f} tiles/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes), launches in {volumes} volumes {launches}")
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


def trainer_phase(bare_step_ms, keep, fp32_step_ms):
    """PretrainTrainer.run_pretraining at full STUNet-B width: 2 epochs x 5
    iterations with the GPU case cache, then a resume from checkpoint_latest
    for 1 epoch x 2 iterations through the host pipeline, then one for 1
    epoch x 6 iterations with a case cache that refills; then a float32 run
    (compute_dtype="float32", `pretrain -compute_dtype float32`) on the same
    cases, 1 epoch x FP32_TRAINER_ITERS with the case cache, its trainer
    built after PyTorch's default TF32 flags are set back (its setup must
    turn them off). Returns the launch counts of the three bf16 runs and of
    the float32 run; the last bf16 run's checkpoint_final.pt is copied to
    `keep` for the supervised phase."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_trainer_dataset(root)
        print(f"[trainer] {TRAINER_CASES} cases of {TRAINER_CASE_SHAPE} written in "
              f"{time.perf_counter() - t0:.1f} s")
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
        del t3, cache
        free_memory()

        fp32 = replace(cfg, compute_dtype="float32", num_epochs=1,
                       iters_per_epoch=FP32_TRAINER_ITERS)
        tf32_defaults()
        t0 = time.perf_counter()
        t4 = PretrainTrainer(TRAINER_DATASET, fp32, device="cuda",
                             output_folder=os.path.join(root, "fp32"))
        check_tf32_off("[trainer] PretrainTrainer(compute_dtype='float32')")
        built = time.perf_counter() - t0
        t4, history4, launches4, peak4 = trainer_run(fp32, trainer=t4, step=FP32_STEP_LAUNCHES,
                                                     val=FP32_VAL_LAUNCHES)
        ran = time.perf_counter() - t0 - built
        check(t4.dtype == torch.float32 and os.path.isfile(
            os.path.join(t4.output_folder, "checkpoint_final.pt")),
              f"float32 run: dtype {t4.dtype}, no checkpoint_final.pt")
        e = t4.epoch_timings[-1]
        print(f"[trainer] float32, TF32 off: trainer built in {built:.1f} s, run_pretraining "
              f"{ran:.1f} s; 1 epoch x {FP32_TRAINER_ITERS} iterations, case "
              f"cache {t4.device_cache.num_slots} slots of {t4.device_cache.slot_shape} "
              f"{t4.device_cache.dtype}; {e['total']:.3f} s (train {e['train']:.3f} s, "
              f"fetch-wait {e['fetch_wait']:.3f} s, val {e['val']:.3f} s, checkpoint "
              f"{e['ckpt']:.3f} s), {e['train'] / FP32_TRAINER_ITERS * 1e3:.1f} ms a step "
              f"through the trainer (bare fp32 step {fp32_step_ms:.1f} ms); losses {history4}; "
              f"peak memory {peak4 / 2**30:.2f} GiB ({peak4} bytes); launches {launches4}")
        del t4
    return {k: launches[k] + launches2[k] + launches3[k] for k in COUNT_KEYS}, launches4


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
    tables (a tile: 7 kernel #1, 10 kernel #2 of which the C = 4 stem on the
    stem variant, 22 moments), and predict_single_npy_array on the resampled case against
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


GATE_TIMES = {}  # (kernel, B, C, F, (X, Y, Z)) -> gate_path's times of that launch shape


def gate_path(label, sites, norms, batch, gen, errs, checked, timed, stem="enc0.0.conv1",
              dx=True):
    """Every launch shape of one path at `batch` against the plain versions,
    with the gates above: kernel #1's forward where it runs it (below
    MIN_VOLUME output voxels) and, with `dx`, its dx at every site but
    `stem`; kernel #2's per-tap forward, with dx through conv3d_zconcat; the
    moments of every norm, square_in_dtype with and without. With `timed`, the times of
    each shape as the phases above take them (a shape an earlier gate_path
    timed keeps those times: GATE_TIMES); else a shape checked before is
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
            known = GATE_TIMES.get(("conv3x3", batch, *key)) if timed else None
            times, (a, r), variant = time_site(*key, gen, batch, timed=timed and known is None)
            times = times or known
            if timed:
                GATE_TIMES[("conv3x3", batch, *key)] = times
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
            known = GATE_TIMES.get(("zslab", batch, C, F, vol)) if timed else None
            a, r, shares, once, variant, times = zconcat_site(C, F, vol, batch, gen, dx=back,
                                                              timed=timed and known is None)
            times = times or known
            if timed:
                GATE_TIMES[("zslab", batch, C, F, vol)] = times
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


EXTRA_STEPS = 3  # untimed steps after the timed ones (some phases' launch totals count them)


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
    for _ in range(EXTRA_STEPS):
        t.train_step(data, seg)
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
    dataset_json, pp_base = tp_.dataset_json, tp_.preprocessed_dataset_folder_base
    del tp_
    free_memory()
    da5_launches = da5_steps(root, dataset_json, pp_base, data, seg)
    runs = (launches, launches2, launches3, launches4, launches5)
    return {k: sum(r[k] for r in runs) for k in COUNT_KEYS}, plain_launches, da5_launches


def da5_steps(root, dataset_json, pp_base, data, seg):
    """DA5_STEPS bare ATKTrainerDA5 steps of the files phase's PlainConvUNet
    on the ATKTrainer steps' batch (data, seg on the card), their launches
    checked; DA5_STEPS calls of its augmentation alone, timed; then one batch
    through the augmentation with every DA5 transform switched on, on the
    card and on the CPU with the same draws: the data within 1e-5 of the
    CPU's largest value where the seg targets agree, and the targets equal on
    >= 99.99% of the voxels (a per-label warp's 0.5 threshold may tie).
    Returns the steps' launches."""
    td = Trainer(plain_unet_plans(), "3d_fullres", 0, dataset_json,
                 get_trainer_config("ATKTrainerDA5"), output_folder=os.path.join(root, "da5"),
                 preprocessed_dataset_folder_base=pp_base, device="cuda")
    td.initialize()
    cfg = td.aug_config
    check(cfg.da5 is not None and cfg.spatial.p_rotation == 0.4
          and cfg.intensity.p_lowres == 0.15, f"ATKTrainerDA5's augmentation {cfg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for step in range(DA5_STEPS):
        before_n = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = td.train_step(data, seg).item()
        times.append((time.perf_counter() - t0) * 1e3)
        n = since(before_n)
        check(math.isfinite(loss) and n == PLAIN_STEP_LAUNCHES,
              f"ATKTrainerDA5 step {step}: loss {loss}, launches {n}, expected "
              f"{PLAIN_STEP_LAUNCHES}")
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    aug_ms = []
    for _ in range(DA5_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        td.train_augment(td.aug_generator, data, seg)
        torch.cuda.synchronize()
        aug_ms.append((time.perf_counter() - t0) * 1e3)
    every = replace(cfg, da5=replace(cfg.da5, **{
        f.name: 1.0 for f in fields(cfg.da5) if f.name.startswith("p_") and f.name != "p_per_channel"}))
    t0 = time.perf_counter()
    draws = draw_all(torch.Generator().manual_seed(11), data.cpu(), every)
    ref_d, ref_t = apply_train_augment(every, draws, data.cpu(), seg.cpu())
    cpu_s = time.perf_counter() - t0
    card = replace(draws, noise=None if draws.noise is None else draws.noise.cuda())
    got_d, got_t = apply_train_augment(every, card, data, seg)
    agree = (got_t[0].cpu() == ref_t[0])
    share = float(agree.float().mean())
    err = float(((got_d.cpu() - ref_d).abs() * agree).max() / ref_d.abs().max())
    check(share >= 0.9999 and err <= 1e-5,
          f"DA5 augmentation card vs CPU: rel err {err}, equal targets {share}")
    print(f"[supervised] ATKTrainerDA5 PlainConvUNet (p_rotation 0.4, DA5's extras, its "
          f"intensity settings): steps {[round(v, 1) for v in times]} ms, augmentation alone "
          f"{[round(v, 1) for v in aug_ms]} ms a batch of {tuple(data.shape)}, peak memory "
          f"{peak / 2**30:.2f} GiB; launches a step {PLAIN_STEP_LAUNCHES}; one batch with every "
          f"DA5 transform on, card vs CPU (same draws; the CPU took {cpu_s:.1f} s): rel err "
          f"{err:.3e} where the targets agree, targets equal on {share:.6f} of the voxels")
    del td, draws, card, ref_d, ref_t, got_d, got_t
    return launches


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
    teacher's forward, the student's and remat's second one, dx); then
    H_EXTRA_STEPS more, one step at grad_accum_steps=1 (B = 4) and one LAMB
    step, each finite, with their own launches.
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
    for _ in range(H_EXTRA_STEPS):
        step(optimizer, micro)
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
    want = {k: (H_STEPS + H_EXTRA_STEPS + 1) * H_STEP_LAUNCHES[k] + H_STEP1_LAUNCHES[k]
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
    cache, validation and the checkpoints. The run writes one checkpoint
    (~16 bytes a parameter: student, teacher, two AdamW moments) and links
    its other names to it; they go to `root`, which the caller deletes; the
    phase first checks that the disk holds three. (The resume is checked at
    STUNet-B: the trainer, multinode and cli phases.) Returns the run's
    launches and its checkpoint_final.pt."""
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
    finally:
        ckpt_mod.save_trainer_checkpoint = save
    free_memory()
    return launches, os.path.join(out, "checkpoint_final.pt")


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


def write_cli_dataset(raw, name=CLI_DATASET, train=CLI_TRAIN, test=CLI_TEST, seed=4):
    """A dataset as a user brings it (CLI_DATASET by default): imagesTr/labelsTr
    (`train`) and imagesTs/labelsTs (`test`) of kidney_case volumes, written
    with the port's NIfTI writer, and dataset.json with
    generate_dataset_json."""
    rs = np.random.default_rng(seed)
    jobs = []
    for split, cases in (("Tr", train), ("Ts", test)):
        for sub in ("images", "labels"):
            os.makedirs(os.path.join(raw, f"{sub}{split}"))
        for case, shape, spacing in cases:
            img, seg = kidney_case(rs, shape, spacing)
            jobs += [(os.path.join(raw, f"images{split}", f"{case}_0000.nii.gz"), img, spacing),
                     (os.path.join(raw, f"labels{split}", f"{case}.nii.gz"), seg, spacing)]
    with ThreadPoolExecutor(8) as pool:  # gzip releases the GIL
        list(pool.map(lambda j: write_nifti(j[0], j[1].transpose(2, 1, 0),
                                            spacing_xyz=j[2][::-1]), jobs))
    generate_dataset_json(raw, {0: "CT"}, CLI_LABELS, len(train), ".nii.gz", dataset_name=name)


def phase_dirs(root):
    """The ATK_raw/ATK_preprocessed/ATK_results tree of a phase in `root`."""
    return {w: os.path.join(root, w) for w in ("raw", "preprocessed", "results")}


def prepare_main(root):
    """A process that main starts after the kernel phases (`--prepare
    <root>`), at the lowest priority, so that the host work of PREPARED runs
    beside the phases before the cli's: for each phase in turn, its dataset written
    into <root>/<phase>/raw, then plan_and_preprocess on it. Each step's
    seconds and the kernel launches into <root>/<phase>.json, its output
    into <root>/<phase>.log."""
    os.nice(19)
    for phase, (name, train, test, seed), argv in PREPARED:
        dirs = phase_dirs(os.path.join(root, phase))
        os.environ.update({f"ATK_{w}": d for w, d in dirs.items()})
        with open(os.path.join(root, phase + ".log"), "w") as log:
            os.dup2(log.fileno(), 1)
            os.dup2(log.fileno(), 2)
            t0 = time.perf_counter()
            write_cli_dataset(os.path.join(dirs["raw"], name), name, train, test, seed)
            rec = dict(write=time.perf_counter() - t0)
            zero_counts()
            t0 = time.perf_counter()
            cli.plan_and_preprocess_entry(argv)
            rec.update(seconds=time.perf_counter() - t0, launches=counts())
            sys.stdout.flush()
            sys.stderr.flush()
        save_json(rec, os.path.join(root, phase + ".json.part"))
        os.replace(os.path.join(root, phase + ".json.part"), os.path.join(root, phase + ".json"))


def start_prepare(root):
    """prepare_main in a process of its own; stopped at exit if it still runs."""
    with open(os.path.join(root, "prepare.log"), "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--prepare", root],
                                stdout=log, stderr=subprocess.STDOUT)
    atexit.register(stop_process, proc)
    return proc


def stop_process(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def wait_prepared(proc, root, phase):
    """The record of `phase`'s part of the preparing process, once it has
    written it; prints that part's output. Fails if the process ended
    without it or if it takes over PREPARE_TIMEOUT seconds more."""
    done = os.path.join(root, phase + ".json")
    t0 = time.perf_counter()
    while not os.path.isfile(done):
        if proc.poll() is not None and not os.path.isfile(done):
            tails = {f: Path(root, f).read_text()[-2000:] for f in sorted(os.listdir(root))
                     if f.endswith(".log")}
            check(False, f"the preparing process exited {proc.returncode} before {phase}'s "
                         f"part; its output ends {tails}")
        check(time.perf_counter() - t0 < PREPARE_TIMEOUT,
              f"the preparing process ran over {PREPARE_TIMEOUT} s more for {phase}")
        time.sleep(1.0)
    with open(os.path.join(root, phase + ".log")) as f:
        sys.stdout.write(f.read())
    print(f"[{phase}] (waited {time.perf_counter() - t0:.1f} s for the preparing process)")
    return load_json(done)


def prepared(phase, proc, root, name, train, test):
    """`phase`'s part of the preparing process (wait_prepared), printed as
    its entries' lines; returns plan_and_preprocess's seconds and launches."""
    rec = wait_prepared(proc, root, phase)
    print(f"[{phase}] {len(train)} training and {len(test)} test cases of {name} written in "
          f"{rec['write']:.1f} s")
    print(f"[{phase}] plan_and_preprocess: {rec['seconds']:.3f} s in the preparing process, "
          f"launches {rec['launches']}")
    return dict(seconds=rec["seconds"], launches=rec["launches"])


def run_entry(tag, runs, steps, name, entry, argv, timer=None):
    """entry(argv) with the launch counts at 0 and the peak memory reset: its
    seconds, peak memory and launches into runs[name], the ms of each step
    that `timer` (a StepTimer) saw into steps[name]; prints a [tag] line."""
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
    line = (f"[{tag}] {name}: {r['seconds']:.3f} s, peak memory {r['peak'] / 2**30:.2f} "
            f"GiB ({r['peak']} bytes), launches {r['launches']}")
    if name in steps:
        ms = steps[name]
        line += (f"; {len(ms)} steps, median {statistics.median(ms):.1f} ms "
                 f"({[round(v, 1) for v in ms]})")
    print(line)
    return r


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


def cli_phase(prep, gen, checked, shapes):
    """The port's command line from a raw dataset to ensembled, postprocessed
    segmentations, each entry called with its argv as a user types it, under
    ATK_raw/ATK_preprocessed/ATK_results in <root>/cli of `prep` (the
    preparing process and its root): the dataset and plan_and_preprocess
    (--verify_dataset_integrity, 4 spawned workers) from the preparing
    process, then cli_gate_phase on the shapes its plans imply; pretrain
    (atk_pretrain's defaults: STUNet-B AnatoMask, 112x112x128, batch 4 in 2
    microbatches, bf16) for 1 epoch x CLI_PRETRAIN_ITERS; train
    ATKTrainer_1epoch fold 0 --npz and STUNetTrainer_base_ft fold 0 from the
    pretraining checkpoint (its preset cut to one epoch), CLI_ITERS
    iterations and CLI_VAL_ITERS validation iterations an epoch; predict the
    test cases with both models, ensemble, evaluate, find_best_configuration,
    apply_postprocessing, accumulate_crossval_results; export_model,
    install_model into a second results tree, whose fold must predict the
    original's logits; move_plans_between_datasets. Checks each output, and
    that pretrain, train and predict launch all three kernels. `shapes`
    (LaunchShapes) records no launch of the gates. Returns the
    launches of the phase, per kernel (max abs err, max rel err) of its
    gates and their totals of one step and one test case."""
    root = os.path.join(prep[1], "cli")
    dirs = phase_dirs(root)
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
        def run(name, entry, argv, timer=None):
            return run_entry("cli", runs, steps, name, entry, argv, timer)

        runs["plan_and_preprocess"] = prepared("cli", *prep, CLI_DATASET, CLI_TRAIN, CLI_TEST)
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
        run(f"train {tr} fold 0", cli.train_entry,
            [str(CLI_ID), "3d_fullres", "0", "-tr", tr, "--npz"], StepTimer(Trainer, "train_step"))
        run(f"train {ft} fold 0", cli.train_entry,
            [str(CLI_ID), "3d_fullres", "0", "-tr", ft, "-pretrained_weights", pretrained],
            StepTimer(Trainer, "train_step"))
        models = {m: os.path.join(dirs["results"], CLI_DATASET, f"{m}__ATKPlans__3d_fullres")
                  for m in (tr, ft)}
        for m in (tr, ft):
            fdir = os.path.join(models[m], "fold_0")
            check(os.path.isfile(os.path.join(fdir, "checkpoint_final.npz")),
                  f"{m} fold 0: no checkpoint_final.npz")
            summary = load_json(os.path.join(fdir, "validation", "summary.json"))
            check(math.isfinite(summary["foreground_mean"]["Dice"]),
                  f"{m} fold 0: validation Dice {summary['foreground_mean']}")
        check(any(f.endswith(".npz") for f in os.listdir(os.path.join(models[tr], "fold_0",
                                                                      "validation"))),
              "train --npz saved no probabilities")

        preds = {tr: os.path.join(root, "pred_atk"), ft: os.path.join(root, "pred_stunet")}
        for m, folds in ((tr, ["0"]), (ft, ["0"])):
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
            [str(CLI_ID), "-c", "3d_fullres", "-tr", tr, "-f", "0"])
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
            [str(CLI_ID), "-tr", tr, "-f", "0"])
        check(os.path.isfile(os.path.join(models[tr] + "_crossval_results", "summary.json")),
              "accumulate_crossval_results: no summary.json")
        print(f"[cli] best: {best['configuration']} (ensemble {best['ensemble']}), Dice "
              f"{best['dice_before_postprocessing']:.4f} -> {best['dice_after_postprocessing']:.4f} "
              f"after postprocessing {best['postprocessing']}")

        zip_file = os.path.join(root, "model.zip")
        run("export_model", cli.export_model_entry,
            [str(CLI_ID), "-o", zip_file, "-tr", tr, "-c", "3d_fullres", "-f", "0"])
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
    for name in ("pretrain", f"train {tr} fold 0", f"train {ft} fold 0",
                 f"predict {tr}", f"predict {ft}"):
        n = runs[name]["launches"]
        check(all(kernel_launches(n, k) > 0 for k in ("conv3x3", "zslab", "moments")),
              f"{name} did not launch every kernel: {n}")
    total = sum(r["seconds"] for r in runs.values() if "seconds" in r)
    print(f"[cli] the entries took {total:.1f} s, the phase {time.perf_counter() - start:.1f} s")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in COUNT_KEYS}
    return launches, gate_errs, plain_step, case


def check_cascade_plans(plans):
    """The plans that plan_and_preprocess wrote for CASCADE_DATASET are what
    the JAX planner plans: 3d_fullres, 3d_lowres and the cascade."""
    configs = plans["configurations"]
    check({"3d_fullres", "3d_lowres", "3d_cascade_fullres"} <= set(configs),
          f"configurations {sorted(configs)}")
    for name, want, spacing in (("3d_fullres", CLI_3D, CASCADE_FULLRES_SPACING),
                                ("3d_lowres", CASCADE_LOWRES, CASCADE_LOWRES_SPACING)):
        c = configs[name]
        check({k: c.get(k) for k in want} == want,
              f"{name} {[(k, c.get(k)) for k in want if c.get(k) != want[k]]}")
        check(np.allclose(c["spacing"], spacing, rtol=1e-6), f"{name} spacing {c['spacing']}")
    casc = configs["3d_cascade_fullres"]
    check({k: casc.get(k) for k in CASCADE_STAGE} == CASCADE_STAGE, f"cascade {casc}")


def cascade_case_forwards():
    """The forwards of one cascade test case and fold: CASCADE_TEST[0] at the
    fullres spacing, two tiles a forward."""
    _, shape, spacing = CASCADE_TEST[0]
    return math.ceil(tiles_of((CASCADE_IN, *compute_new_shape(
        shape, spacing, CASCADE_FULLRES_SPACING))) / 2)


def cascade_gate_phase(gen, checked):
    """The launch shapes that the cascade adds, against the plain versions
    with gate_path's gates, before an entry runs them: the cascade
    PlainConvUNet (CASCADE_IN input channels: the stem at C = 3 on kernel
    #2's stem variant) at its training batch 2 and at CLI_TILE_BATCH,
    timed. The lowres stage's shapes are the cli phase's (one input
    channel). Returns per kernel (max abs err, max rel err), the totals of
    one cascade step and of one cascade test case and fold (CASCADE_TEST[0]
    at the fullres spacing)."""
    errs = {k: [0.0, 0.0] for k in ("conv3x3", "zslab", "moments")}
    sites = plain_sites(CASCADE_IN)
    t = gate_path("cascade", sites, PLAIN_INFER_NORMS, CLI_3D["batch_size"], gen, errs, checked,
                  True, "enc0.conv0")
    step = step_totals(t, sites, PLAIN_INFER_NORMS, CLI_3D["batch_size"], lambda n: 1,
                       lambda n: int(n != "enc0.conv0"))
    print_totals("cascade", f"one cascade PlainConvUNet step at B={CLI_3D['batch_size']}", step)
    t = gate_path("cascade", sites, PLAIN_INFER_NORMS, CLI_TILE_BATCH, gen, errs, checked, True,
                  dx=False)
    forwards = cascade_case_forwards()
    case = step_totals(t, sites, PLAIN_INFER_NORMS, CLI_TILE_BATCH, lambda n: forwards,
                       lambda n: 0)
    print_totals("cascade", f"one cascade test case and fold ({forwards} forwards at "
                            f"B={CLI_TILE_BATCH})", case)
    return errs, step, case


def cascade_phase(prep, gates, shapes):
    """The 3d_lowres -> 3d_cascade_fullres cascade through the port's command
    line, each entry with the argv a user types, under
    ATK_raw/ATK_preprocessed/ATK_results in <root>/cascade of `prep` (the
    preparing process and its root), after cascade_gate_phase (`gates`, its
    results): CASCADE_DATASET written as write_cli_dataset writes one and
    plan_and_preprocess -c 3d_fullres 3d_lowres, from the preparing process,
    whose plans must be the JAX planner's; train ATKTrainer_1epoch 3d_lowres fold all (its final validation
    predicts every case, so every training case gets its
    predicted_next_stage), then 3d_cascade_fullres fold 0 (the host
    pipeline: the case cache turns itself off for a cascade), CLI_ITERS
    iterations and CLI_VAL_ITERS validation iterations each; predict the test
    case with 3d_lowres fold all, then with 3d_cascade_fullres fold 0 from
    those predictions (-prev_stage_predictions). Checks every case's
    predicted_next_stage on the fullres grid, the cascade network's 3 input
    channels, the cascade's summary.json, every test output's raw shape and
    labels, each entry's launches by kernel and variant, that every train
    and predict launches all three kernels. Returns the launches of the
    phase, then `gates`: per kernel (max abs err, max rel err) and the
    totals of one cascade step and one cascade test case."""
    root = os.path.join(prep[1], "cascade")
    dirs = phase_dirs(root)
    raw = os.path.join(dirs["raw"], CASCADE_DATASET)
    env = {**{f"ATK_{w}": d for w, d in dirs.items()},
           "ATK_ITERS_PER_EPOCH": str(CLI_ITERS), "ATK_VAL_ITERS": str(CLI_VAL_ITERS)}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    runs, steps = {}, {}
    start = time.perf_counter()
    tr, ident = "ATKTrainer_1epoch", str(CASCADE_ID)

    def run(name, entry, argv, timer=None):
        return run_entry("cascade", runs, steps, name, entry, argv, timer)

    try:
        runs["plan_and_preprocess"] = prepared("cascade", *prep, CASCADE_DATASET, CASCADE_TRAIN,
                                               CASCADE_TEST)
        pp = os.path.join(dirs["preprocessed"], CASCADE_DATASET)
        plans = load_json(os.path.join(pp, "ATKPlans.json"))
        check_cascade_plans(plans)
        pp_shapes = {}
        for config in ("3d_fullres", "3d_lowres"):
            folder = os.path.join(pp, plans["configurations"][config]["data_identifier"])
            for name, *_ in CASCADE_TRAIN:
                with np.load(os.path.join(folder, name + ".npz")) as z:
                    pp_shapes[(config, name)] = z["data"].shape
        print(f"[cascade] plans as the JAX planner's: 3d_fullres {CLI_3D}, 3d_lowres at "
              f"{CASCADE_LOWRES_SPACING} mm (next stage 3d_cascade_fullres), the cascade "
              f"{CASCADE_STAGE}; preprocessed shapes {sorted(set(pp_shapes.items()))}")

        def forwards(config, n):  # the forwards of a final validation or a predict
            return sum(math.ceil(tiles_of(pp_shapes[(config, name)]) / 2)
                       for name, *_ in CASCADE_TRAIN[:n])

        train_want = {}
        for config, fold, n_in, val_cases in (("3d_lowres", "all", 1, len(CASCADE_TRAIN)),
                                              ("3d_cascade_fullres", "0", CASCADE_IN, None)):
            name = f"train {tr} {config} fold {fold}"
            run(name, cli.train_entry, [ident, config, fold, "-tr", tr],
                StepTimer(Trainer, "train_step"))
            model = os.path.join(dirs["results"], CASCADE_DATASET, f"{tr}__ATKPlans__{config}")
            fdir = os.path.join(model, f"fold_{fold}")
            summary = load_json(os.path.join(fdir, "validation", "summary.json"))
            check(math.isfinite(summary["foreground_mean"]["Dice"]),
                  f"{name}: validation Dice {summary['foreground_mean']}")
            sites = plain_sites(n_in)
            if val_cases is None:
                val_keys = load_json(os.path.join(pp, "splits_final.json"))[int(fold)]["val"]
                n_val = sum(math.ceil(tiles_of(pp_shapes[("3d_fullres", k)]) / 2)
                            for k in val_keys)
            else:
                n_val = forwards("3d_lowres", val_cases)
            step_l = path_launches(sites, PLAIN_INFER_NORMS, 1, True)
            fwd_l = path_launches(sites, PLAIN_INFER_NORMS, 1, False)
            train_want[name] = {k: CLI_ITERS * step_l[k] + (CLI_VAL_ITERS + n_val) * fwd_l[k]
                                for k in COUNT_KEYS}
            check(runs[name]["launches"] == train_want[name],
                  f"{name}: launches {runs[name]['launches']}, expected {train_want[name]}")
            arrays, _ = ckpt_mod.load_checkpoint(os.path.join(fdir, "checkpoint_final.npz"))
            stem = next(v for v in plain_unet_state_dict_from_jax(
                arrays["network_weights"]).values() if v.ndim == 5)
            check(stem.shape[1] == n_in, f"{name}: the network reads {stem.shape[1]} channels")
        nxt = os.path.join(dirs["results"], CASCADE_DATASET, f"{tr}__ATKPlans__3d_lowres",
                           "predicted_next_stage", "3d_cascade_fullres")
        for name, *_ in CASCADE_TRAIN:
            with np.load(os.path.join(nxt, name + ".npz")) as z:
                seg = z["seg"]
            check(seg.shape == pp_shapes[("3d_fullres", name)][1:]
                  and set(np.unique(seg).tolist()) <= {0, 1, 2},
                  f"predicted_next_stage {name}: shape {seg.shape}, labels {np.unique(seg)}")
        print(f"[cascade] predicted_next_stage/3d_cascade_fullres holds every training case on "
              f"the fullres grid; the cascade network reads {CASCADE_IN} channels")

        preds = {c: os.path.join(root, f"pred_{c}") for c in ("3d_lowres", "3d_cascade_fullres")}
        for config, fold, n_in, spacing, extra in (
                ("3d_lowres", "all", 1, CASCADE_LOWRES_SPACING, []),
                ("3d_cascade_fullres", "0", CASCADE_IN, CASCADE_FULLRES_SPACING,
                 ["-prev_stage_predictions", preds["3d_lowres"]])):
            name = f"predict {config}"
            r = run(name, cli.predict_entry,
                    ["-i", os.path.join(raw, "imagesTs"), "-o", preds[config], "-d", ident,
                     "-c", config, "-tr", tr, "-f", fold, *extra])
            n = sum(math.ceil(tiles_of((n_in, *compute_new_shape(shape, sp, spacing))) / 2)
                    for _, shape, sp in CASCADE_TEST)
            fwd_l = path_launches(plain_sites(n_in), PLAIN_INFER_NORMS, 1, False)
            want = {k: n * fwd_l[k] for k in COUNT_KEYS}
            check(r["launches"] == want, f"{name}: launches {r['launches']}, expected {want}")
            for case, shape, _ in CASCADE_TEST:
                seg = NiftiIO().read_seg(os.path.join(preds[config], case + ".nii.gz"))[0][0]
                check(seg.shape == shape and set(np.unique(seg).tolist()) <= {0, 1, 2},
                      f"{name} {case}: shape {seg.shape}, labels {np.unique(seg)}")
            print(f"[cascade] {name}: {r['seconds'] / len(CASCADE_TEST):.3f} s a test case "
                  f"({n} forwards of B={CLI_TILE_BATCH} in all); outputs at the raw shapes")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name, r in runs.items():
        if name.startswith(("train", "predict")):
            check(all(kernel_launches(r["launches"], k) > 0
                      for k in ("conv3x3", "zslab", "moments")),
                  f"{name} did not launch every kernel: {r['launches']}")
    total = sum(r["seconds"] for r in runs.values())
    print(f"[cascade] the entries took {total:.1f} s, the phase {time.perf_counter() - start:.1f} s")
    launches = {k: sum(r["launches"][k] for r in runs.values()) for k in COUNT_KEYS}
    return (launches, *gates)


# --- the ddp phase: data parallelism, world 2 against world 1 -------------------

DDP_WORLD = 2
DDP_GLOBAL, DDP_ACCUM, DDP_STEPS = 4, 2, 3  # pretraining: 2 rows a rank, microbatches of 1
DDP_SUP_GLOBAL, DDP_SUP_STEPS = 2, 2        # supervised: 1 row a rank
DDP_MICRO = DDP_GLOBAL // DDP_ACCUM // DDP_WORLD  # a rank's share of a microbatch
DDP_PRETRAIN = {"STUNet-B SparK": {},
                "STUNet-B SparK, batch-pooled norms, decoder bn": dict(
                    norm_batch_pooled=True, decoder_norm="bn")}
DDP_SUP = ("STUNetTrainer_base_ft", "ATKTrainerBN")
DDP_SUP_JSON = {"channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1, "b": 2},
                "numTraining": 4, "file_ending": ".nii.gz"}
# a rank's launches: a pretraining step runs DDP_ACCUM microbatches (teacher
# and student forward, the student's dx), a supervised step one forward and dx
DDP_STEP_LAUNCHES = {k: DDP_ACCUM * v for k, v in STEP_LAUNCHES.items()}
DDP_SUP_LAUNCHES = {"STUNetTrainer_base_ft": SUP_STEP_LAUNCHES,
                    "ATKTrainerBN": path_launches(plain_sites(1), PLAIN_INFER_NORMS, 1, True)}
# world 2 against world 1 on the same global batch and draws (bf16; the
# collectives add the ranks' fp32 sums in another order): the losses
# relative, every weight within this share of the largest weight. Measured
# on an H100 (the first run of this phase): losses within 3.4e-4, weights
# within 1.7e-4 of the largest after 3 pretraining steps (7.6e-5 after 2
# supervised); the limits hold about 6x that
DDP_LOSS_RTOL, DDP_WEIGHT_TOL = 2e-3, 1e-3
# the val step's hard Dice counts on the initial weights, each relative: an
# untrained net's logits nearly tie, and BatchNorm's statistics summed in
# another order move the argmax of a few voxels (1.3e-3 measured)
DDP_COUNT_RTOL = 1e-2


def ddp_settings():
    """The numerics every process of the phase shares: no TF32, cuDNN held to
    its deterministic algorithms (world 1 with a group must equal world 1
    without one bit for bit)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False


def digest(t):
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()).hexdigest()


def flat_params(module):
    return torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])


def ddp_compare(folder, tag, last, tensors):
    """After a run's `last` step: the world-1 run (no group) saves the flat
    tensors; a run in a group returns their largest difference from them."""
    path = os.path.join(folder, f"{tag}.pt")
    if not last:
        return {}
    if not mesh.distributed():
        torch.save({k: v.cpu() for k, v in tensors.items()}, path)
        return {}
    ref = torch.load(path)
    return {f"d_{k}": float((v - ref[k].to(v.device)).abs().max()) for k, v in tensors.items()}


def ddp_pretrain_run(folder, tag, kw):
    """DDP_STEPS AnatoMask steps of a full-width STUNet-B SparK (patch
    112x112x128, bf16, decoder width 512) with `kw`, global batch DDP_GLOBAL
    in DDP_ACCUM microbatches, on this rank's rows of one seeded global batch
    and noise; a record of each step and of the run."""
    cfg = PretrainConfig(grad_accum_steps=DDP_ACCUM, **kw)
    student = build_spark_model(cfg, device="cuda:0", generator=torch.Generator().manual_seed(0))
    teacher, optimizer = make_teacher(student), make_optimizer(student)
    L = math.prod(student.fmap)
    len_loss = int((L - student.len_keep) * 0.25)
    gen = torch.Generator().manual_seed(31)
    x = torch.rand((DDP_GLOBAL, 1, *cfg.patch_size), generator=gen).to(torch.bfloat16)
    noise = torch.rand((DDP_STEPS, 2, DDP_GLOBAL, L), generator=gen)
    rows = mesh.local_rows(DDP_GLOBAL, DDP_ACCUM)
    x = (x if rows is None else x[rows]).to("cuda:0").contiguous(
        memory_format=torch.channels_last_3d)
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for step in range(DDP_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = anatomask_train_step(student, teacher, optimizer, x, len_loss,
                                          noise=noise[step].to("cuda:0"),
                                          grad_accum_steps=DDP_ACCUM)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = since(before)
        s, t = flat_params(student), flat_params(teacher)
        steps.append(dict(loss=loss.item(), ms=ms, launches=n, student=digest(s),
                          teacher=digest(t), scale=float(s.abs().max()),
                          **ddp_compare(folder, tag, step == DDP_STEPS - 1,
                                        {"student": s, "teacher": t})))
    rec = dict(steps=steps, launches=counts(), peak=torch.cuda.max_memory_allocated())
    if mesh.distributed():  # the gradients' all-reduce alone, as the step makes it
        grads = torch.cat([p.grad.reshape(-1) for p in student.parameters()])
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.distributed.all_reduce(grads)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rec.update(allreduce_ms=statistics.median(times), allreduce_bytes=grads.numel() * 4)
    return rec


def ddp_sup_batches(patch, spatial, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((DDP_SUP_GLOBAL, *spatial, 1), generator=gen),
            torch.randint(0, 3, (DDP_SUP_GLOBAL, *spatial, 1), generator=gen).to(torch.int16))


def ddp_sup_run(folder, preset, tag=""):
    """One Trainer.val_step of `preset` (bf16, the supervised phase's 128^3
    plans: STUNet-B for STUNetTrainer_base_ft, the 32-320 PlainConvUNet with
    BatchNorm for ATKTrainerBN; batch Dice) on the initial weights, then
    DDP_SUP_STEPS train_steps, each on this rank's rows of a seeded global
    batch of DDP_SUP_GLOBAL."""
    out = os.path.join(folder, f"{tag}{preset}-{mesh.world()}-{mesh.distributed()}")
    t = Trainer(supervised_plans(), "3d_fullres", 0, DDP_SUP_JSON, get_trainer_config(preset),
                output_folder=out, preprocessed_dataset_folder_base=out, device="cuda:0")
    t.initialize()
    rows = mesh.local_rows(DDP_SUP_GLOBAL)
    data, seg = ddp_sup_batches(PATCH, PATCH, 50)
    if rows is not None:
        data, seg = data[rows], seg[rows]
    val = [v.float().cpu().reshape(-1).tolist() for v in t.val_step(data.to("cuda:0"),
                                                                     seg.to("cuda:0"))]
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    for step in range(DDP_SUP_STEPS):
        data, seg = ddp_sup_batches(PATCH, t.initial_patch_size, 40 + step)
        if rows is not None:
            data, seg = data[rows], seg[rows]
        data, seg = data.to("cuda:0"), seg.to("cuda:0")
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = t.train_step(data, seg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = since(before)
        w = flat_params(t.network)
        steps.append(dict(loss=loss.item(), ms=ms, launches=n, weights=digest(w),
                          scale=float(w.abs().max()),
                          **ddp_compare(folder, preset, step == DDP_SUP_STEPS - 1,
                                        {"weights": w})))
    return dict(steps=steps, peak=torch.cuda.max_memory_allocated(), val=val)


def ddp_step_records(folder, tag):
    """The pretraining and supervised runs of this rank of a group, every
    kernel launch shape recorded; the record into <folder>/<tag>rank<r>.json."""
    shapes = LaunchShapes()
    rec = {"pretrain": {label: ddp_pretrain_run(folder, f"pretrain{i}", kw)
                        for i, (label, kw) in enumerate(DDP_PRETRAIN.items())},
           "supervised": {p: ddp_sup_run(folder, p, tag) for p in DDP_SUP}}
    free_memory()
    rec["shapes"] = {k: sorted(getattr(shapes, k)) for k in ("conv", "zslab", "moments")}
    rec["backend"] = torch.distributed.get_backend()
    with open(os.path.join(folder, f"{tag}rank{mesh.rank()}.json"), "w") as f:
        json.dump(rec, f)


def ddp_nccl_main(folder):
    """The rank that ddp_phase spawns through parallel/mesh.py launch at
    world 1 on "cuda" (NCCL, card 0): the kernels loaded, the numerics of
    ddp_settings, the first pretraining case; its record into
    <folder>/launch-nccl.json."""
    ddp_settings()
    for name in ("conv3x3", "moments", "zslab_conv"):
        _build.load(name)
    shapes = LaunchShapes()
    label, kw = next(iter(DDP_PRETRAIN.items()))
    rec = {"pretrain": {label: ddp_pretrain_run(folder, "pretrain0", kw)}, "supervised": {},
           "backend": torch.distributed.get_backend(), "device": str(mesh.rank_device("cuda")),
           "shapes": {k: sorted(getattr(shapes, k)) for k in ("conv", "zslab", "moments")}}
    with open(os.path.join(folder, "launch-nccl.json"), "w") as f:
        json.dump(rec, f)


def ddp_gate_phase(gen, checked):
    """The launch shapes of a rank's steps, against the plain versions with
    gate_path's gates, before the ranks run them: the pretraining step at a
    rank's microbatch B = 1 (its two microbatches, timed), the STUNet-B
    finetuning step at B = 1 (timed), the 32-320 PlainConvUNet step at B = 1
    (checked only). Returns per kernel (max abs err, max rel err) and the
    totals of one rank's pretraining step and STUNet-B step."""
    errs = {k: [0.0, 0.0] for k in ("conv3x3", "zslab", "moments")}
    stem = "enc0.conv1"
    t = gate_path("ddp", SITES, PRETRAIN_NORMS, DDP_MICRO, gen, errs, checked, True, stem)
    pre = step_totals(t, SITES, PRETRAIN_NORMS, DDP_MICRO, lambda n: 2 * DDP_ACCUM,
                      lambda n: DDP_ACCUM * int(n != stem))
    print_totals("ddp", f"one rank's pretraining step ({DDP_ACCUM} microbatches at B="
                        f"{DDP_MICRO})", pre)
    t = gate_path("ddp", INFER_SITES, INFER_NORMS, 1, gen, errs, checked, True, stem)
    sup = step_totals(t, INFER_SITES, INFER_NORMS, 1, lambda n: 1, lambda n: int(n != stem))
    print_totals("ddp", "one rank's STUNet-B finetuning step at B=1", sup)
    gate_path("ddp", plain_sites(1), PLAIN_INFER_NORMS, 1, gen, errs, checked, False,
              "enc0.conv0")
    return errs, pre, sup


def ddp_check_pair(label, got, want, keys):
    """A rank against world 1: each step's loss within DDP_LOSS_RTOL, the
    weights (keys) after the last within DDP_WEIGHT_TOL of the largest."""
    for s, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
        check(math.isfinite(g["loss"]) and rel <= DDP_LOSS_RTOL,
              f"{label} step {s}: loss {g['loss']} against world 1's {w['loss']}")
    g, w = got["steps"][-1], want["steps"][-1]
    for k in keys:
        check(g[f"d_{k}"] <= DDP_WEIGHT_TOL * w["scale"],
              f"{label}: {k} {g[f'd_{k}']} from world 1's after the last step (largest "
              f"{w['scale']})")


def ddp_launches(records):
    """The launches of the records' steps, by COUNT_KEYS."""
    launches = dict.fromkeys(COUNT_KEYS, 0)
    for r in records:
        for kind in ("pretrain", "supervised"):
            for run in r[kind].values():
                for s in run["steps"]:
                    for k in COUNT_KEYS:
                        launches[k] += s["launches"][k]
    return launches


def add_shapes(shapes, records):
    for r in records:
        for k in ("conv", "zslab", "moments"):
            getattr(shapes, k).update(tuple(v) for v in r["shapes"][k])


def same_steps(got, want, keys):
    """Whether two records' runs agree bit for bit: each step's loss and the
    digests of `keys`."""
    return all(a["loss"] == b["loss"] and all(a[k] == b[k] for k in keys)
               for a, b in zip(got["steps"], want["steps"]))


def ddp_phase(root, gen, checked, shapes):
    """Data parallelism on the card (parallel/mesh.py): the AnatoMask step
    at full STUNet-B width (global batch 4, 2 microbatches, bf16, 3 steps),
    the same with the batch-pooled norms and decoder norm "bn", and 2
    supervised steps of STUNetTrainer_base_ft and ATKTrainerBN (global batch
    2, batch Dice) at world 1 without a group, recorded for the multinode
    phase's ranks; then `launch` at world 1 on "cuda" (a spawned rank, NCCL,
    card 0) runs the first pretraining case, bit-equal to no group. Writes
    the trainer and supervised datasets into `root` for the multinode phase.
    Returns the launches of the spawned rank's run, the kernel errors and
    totals of ddp_gate_phase, and the records (the folder, world 1's)."""
    with shapes.paused():
        errs, pre_tot, sup_tot = ddp_gate_phase(gen, checked)
    free_memory()
    folder = os.path.join(root, "records")
    os.makedirs(folder)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    ddp_settings()
    t0 = time.perf_counter()
    one = {"pretrain": {label: ddp_pretrain_run(folder, f"pretrain{i}", kw)
                        for i, (label, kw) in enumerate(DDP_PRETRAIN.items())},
           "supervised": {p: ddp_sup_run(folder, p) for p in DDP_SUP}}
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    free_memory()
    print(f"[ddp] world 1 without a group: {time.perf_counter() - t0:.1f} s")
    write_trainer_dataset(root)
    write_supervised_dataset(root)
    t0 = time.perf_counter()
    mesh.launch(ddp_nccl_main, 1, "cuda", folder)
    t_nccl = time.perf_counter() - t0
    with open(os.path.join(folder, "launch-nccl.json")) as f:
        nccl = json.load(f)
    check(nccl["backend"] == "nccl" and nccl["device"] == "cuda:0",
          f"launch's rank: backend {nccl['backend']}, device {nccl['device']}")
    add_shapes(shapes, [nccl])
    (label, n), = nccl["pretrain"].items()
    want = one["pretrain"][label]
    check(same_steps(n, want, ("student", "teacher", "launches"))
          and n["steps"][-1]["d_student"] == 0 == n["steps"][-1]["d_teacher"],
          f"{label}: world 1 over NCCL through launch is not bit-equal to world 1 without a "
          f"group")
    print(f"[ddp] {label}, global batch {DDP_GLOBAL} in {DDP_ACCUM} microbatches: world 1 "
          f"over NCCL through launch (a spawned rank on {nccl['device']}, {t_nccl:.1f} s of "
          f"process) bit-equal to no group, losses {[s['loss'] for s in n['steps']]}; step ms "
          f"{[round(s['ms'], 1) for s in n['steps']]} (no group "
          f"{[round(s['ms'], 1) for s in want['steps']]}); NCCL all-reduce of "
          f"{n['allreduce_bytes']} bytes {n['allreduce_ms']:.3f} ms; launches a step "
          f"{n['steps'][0]['launches']}")
    return ddp_launches([nccl]), errs, pre_tot, sup_tot, (folder, one)


# --- the multinode phase: PyTorch's launcher across two nodes -------------------

MN_NODES = 2
MN_TIMEOUT = 600  # seconds a launcher node may take before it is killed
# the entries' runs: the pretraining entry at
# global batch 2 in one microbatch (1 row a rank), 1 epoch x 2 iterations,
# then a resume for 1 x 1; STUNetTrainer_base_ft fold 0, 1 epoch x 2
# iterations + 1 validation iteration, then a resume for a second epoch; each
# train run ends with the final validation
MN_PRETRAIN = ["pretrain", TRAINER_DATASET, "-model", "B", "-batch_size", "2", "-grad_accum",
               "1", "-device", "cuda:0"]
MN_TRAIN = ["train", SUP_DATASET, "3d_fullres", "0", "-tr", "STUNetTrainer_base_ft", "-device",
            "cuda:0"]
MN_ENTRIES = (("pretrain", None, MN_PRETRAIN + ["-epochs", "1", "-iters_per_epoch", "2"]),
              ("pretrain resume", None,
               MN_PRETRAIN + ["-epochs", "2", "-iters_per_epoch", "1", "--continue"]),
              ("train", 1, MN_TRAIN), ("train resume", 2, MN_TRAIN + ["--c"]))


def multinode_entries(folder):
    """MN_ENTRIES through `cli.main` as a user's `torchrun ... -m
    anatomask_torch.cli` runs them, each joining the launcher's group anew
    (the epochs of a train run set on its preset); records which checkpoint
    files and validation cases this rank wrote, each entry's seconds and
    launches, and the launch shapes, into <folder>/entries-rank<RANK>.json."""
    from anatomask_torch.inference import export as export_mod
    wrote, predicted, runs = [], [], {}
    save_pt, save_npz, link = (ckpt_mod.save_trainer_checkpoint, ckpt_mod.save_checkpoint,
                               ckpt_mod.link_checkpoint)
    export, get_config = export_mod.export_prediction_from_logits, trainer_mod.get_trainer_config

    def record(write, at):
        def wrapped(*a, **kw):
            wrote.append(os.path.basename(a[at]))
            return write(*a, **kw)
        return wrapped

    def record_export(logits, props, cm, pm, dj, out, *a, **kw):
        predicted.append(os.path.basename(out))
        return export(logits, props, cm, pm, dj, out, *a, **kw)

    ckpt_mod.save_trainer_checkpoint, ckpt_mod.save_checkpoint = record(save_pt, 0), record(
        save_npz, 0)
    ckpt_mod.link_checkpoint = record(link, 1)
    export_mod.export_prediction_from_logits = record_export
    shapes = LaunchShapes()
    try:
        for label, epochs, argv in MN_ENTRIES:
            trainer_mod.get_trainer_config = (
                get_config if epochs is None
                else lambda name, n=epochs: replace(get_config(name), num_epochs=n))
            zero_counts()
            t0 = time.perf_counter()
            cli.main(argv)
            runs[label] = dict(seconds=time.perf_counter() - t0, launches=counts())
    finally:
        ckpt_mod.save_trainer_checkpoint, ckpt_mod.save_checkpoint = save_pt, save_npz
        ckpt_mod.link_checkpoint = link
        export_mod.export_prediction_from_logits = export
        trainer_mod.get_trainer_config = get_config
    rec = dict(runs=runs, wrote=wrote, predicted=predicted,
               shapes={k: sorted(getattr(shapes, k)) for k in ("conv", "zslab", "moments")})
    with open(os.path.join(folder, f"entries-rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(rec, f)


def multinode_rank_main(mode, folder):
    """A process that the launcher started (`--multinode-rank`): the kernels
    loaded, ddp_settings; mode "gloo": the ddp phase's step cases as its
    rank of the two nodes on cuda:0 (`mesh.run_joined`), then the entries;
    mode "nccl": the step cases on its node's card over NCCL."""
    ddp_settings()
    for name in ("conv3x3", "moments", "zslab_conv"):
        _build.load(name)
    device = "cuda" if mode == "nccl" else "cuda:0"

    def steps():
        ddp_step_records(folder, f"{mode}-")
        with open(os.path.join(folder, f"{mode}-device{mesh.rank()}.json"), "w") as f:
            json.dump({"device": str(mesh.rank_device(device)),
                       "local_rank": os.environ["LOCAL_RANK"]}, f)

    mesh.run_joined(steps, device)
    if mode == "gloo":
        free_memory()
        multinode_entries(folder)


def start_nodes(groups, env):
    """For each (nodes, per_node, args) of `groups`, all started at once:
    `nodes` launcher nodes on 127.0.0.1 (torch.distributed.run, a free port
    a group), each `per_node` processes of this script with `args`; killed
    at exit if they still run. Returns the groups' processes and the start."""
    ports = []
    while len(ports) < len(groups):
        port = mesh._free_port()
        ports += [port] if port not in ports else []
    t0 = time.perf_counter()
    procs = [[subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(nodes),
         "--nproc_per_node", str(per_node), "--node_rank", str(k), "--master_addr", "127.0.0.1",
         "--master_port", str(port), os.path.abspath(__file__), "--multinode-rank", *args],
        env=env) for k in range(nodes)] for (nodes, per_node, args), port in zip(groups, ports)]
    for p in sum(procs, []):
        atexit.register(stop_process, p)
    return procs, t0


def wait_nodes(started):
    """Waits for every node that start_nodes started and fails if one fails
    or outlasts MN_TIMEOUT from the start (every node is killed then).
    Returns each group's seconds from the start to the end of its last node."""
    procs, t0 = started
    seconds = [None] * len(procs)
    try:
        while None in seconds:
            check(time.perf_counter() - t0 < MN_TIMEOUT,
                  f"a launcher node ran over {MN_TIMEOUT} s")
            for g, group in enumerate(procs):
                if seconds[g] is None and all(p.poll() is not None for p in group):
                    seconds[g] = time.perf_counter() - t0
            time.sleep(0.5)
    finally:
        for p in sum(procs, []):
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in sum(procs, [])),
          f"launcher nodes exited {[[p.returncode for p in group] for group in procs]}")
    return seconds


def check_world2(one, ranks):
    """The launcher nodes' step records at world 2 against world 1 without a
    group (the ddp phase's `one`): each step's launches, the ranks' weights
    and teachers bit-identical after every step, losses and weights within
    DDP_LOSS_RTOL / DDP_WEIGHT_TOL, the val step's loss and counts within
    DDP_LOSS_RTOL / DDP_COUNT_RTOL."""
    for label, want in one["pretrain"].items():
        got = [r["pretrain"][label] for r in ranks]
        for s in range(DDP_STEPS):
            check(len({g["steps"][s]["student"] for g in got}) == 1
                  and len({g["steps"][s]["teacher"] for g in got}) == 1,
                  f"{label} step {s}: the ranks' weights or teachers differ")
            check(all(g["steps"][s]["launches"] == DDP_STEP_LAUNCHES for g in got),
                  f"{label} step {s}: launches {[g['steps'][s]['launches'] for g in got]}, "
                  f"expected {DDP_STEP_LAUNCHES} a rank")
        for g in got:
            ddp_check_pair(label, g, want, ("student", "teacher"))
        print(f"[multinode] {label}, global batch {DDP_GLOBAL} in {DDP_ACCUM} microbatches, "
              f"{DDP_GLOBAL // DDP_WORLD} rows a rank, bf16: losses world 1 "
              f"{[s['loss'] for s in want['steps']]}, world 2 "
              f"{[s['loss'] for s in got[0]['steps']]}; largest weight difference from world "
              f"1 after {DDP_STEPS} steps {[g['steps'][-1]['d_student'] for g in got]} "
              f"(student), {[g['steps'][-1]['d_teacher'] for g in got]} (teacher), largest weight "
              f"{want['steps'][-1]['scale']}; the ranks bit-identical after every step")
        print(f"[multinode] {label}: step ms world 1 {[round(s['ms'], 1) for s in want['steps']]}"
              f", a rank at world 2 {[[round(s['ms'], 1) for s in g['steps']] for g in got]}; "
              f"gloo all-reduce of {got[0]['allreduce_bytes']} bytes of gradients "
              f"{got[0]['allreduce_ms']:.1f} ms; peak memory a rank "
              f"{[round(g['peak'] / 2**30, 2) for g in got]} GiB (world 1 "
              f"{want['peak'] / 2**30:.2f}); launches a rank a step "
              f"{got[0]['steps'][0]['launches']}")
    for preset, want in one["supervised"].items():
        got = [r["supervised"][preset] for r in ranks]
        for s in range(DDP_SUP_STEPS):
            check(len({g["steps"][s]["weights"] for g in got}) == 1,
                  f"{preset} step {s}: the ranks' weights differ")
            check(all(g["steps"][s]["launches"] == DDP_SUP_LAUNCHES[preset] for g in got),
                  f"{preset} step {s}: launches {[g['steps'][s]['launches'] for g in got]}")
        for g in got:
            ddp_check_pair(preset, g, want, ("weights",))
            loss, counts_ = g["val"][0][0], g["val"][1:]
            check(abs(loss - want["val"][0][0]) <= DDP_LOSS_RTOL * abs(want["val"][0][0])
                  and all(abs(a - b) <= DDP_COUNT_RTOL * b for x, y in zip(counts_, want["val"][1:])
                          for a, b in zip(x, y)),
                  f"{preset}: val loss and counts {g['val']} against world 1's {want['val']}")
        print(f"[multinode] {preset}, global batch {DDP_SUP_GLOBAL}, 1 row a rank, bf16: losses "
              f"world 1 {[s['loss'] for s in want['steps']]}, world 2 "
              f"{[s['loss'] for s in got[0]['steps']]}; largest weight difference after "
              f"{DDP_SUP_STEPS} steps {[g['steps'][-1]['d_weights'] for g in got]} (largest weight "
              f"{want['steps'][-1]['scale']}); val loss {got[0]['val'][0]} (world 1 "
              f"{want['val'][0]}), counts {got[0]['val'][1:]} (world 1 {want['val'][1:]}); "
              f"step ms world 1 {[round(s['ms'], 1) for s in want['steps']]}, a rank "
              f"{[[round(s['ms'], 1) for s in g['steps']] for g in got]}; peak a rank "
              f"{[round(g['peak'] / 2**30, 2) for g in got]} GiB (world 1 "
              f"{want['peak'] / 2**30:.2f})")


def start_multinode(root, folder):
    """The multinode phase's nodes (see multinode_phase) started on the ddp
    phase's datasets in `root` and records in `folder`: one NCCL node and
    MN_NODES gloo nodes at once."""
    env = dict(os.environ, ATK_preprocessed=os.path.join(root, "preprocessed"),
               ATK_results=os.path.join(root, "results"), ATK_raw=os.path.join(root, "raw"),
               ATK_N_PROC_DA="2", ATK_ITERS_PER_EPOCH="2", ATK_VAL_ITERS="1")
    for k in mesh.LAUNCHER_VARIABLES:
        env.pop(k, None)
    return start_nodes([(1, 1, ["nccl", folder]), (MN_NODES, 1, ["gloo", folder])], env)


def multinode_phase(root, records, shapes, started):
    """Training across nodes through PyTorch's launcher (parallel/mesh.py
    run_joined, cli.py), on the ddp phase's records and datasets in `root`:
    one node of one process over NCCL (`--multinode-rank nccl`, -device
    cuda: its card LOCAL_RANK) runs the ddp phase's step cases bit-equal to
    world 1 without a group, and two nodes of one process each sharing the
    card over gloo (`--multinode-rank gloo`, -device cuda:0; NCCL refuses
    two ranks on one card) run them at world 2 as global ranks 0 and 1
    (check_world2), then pretrain and train (STUNetTrainer_base_ft) through
    the entries with a resume each and the final validation: checkpoints
    from global rank 0 alone, validation cases [rank::2], rank 0's
    summary.json of every case, kernels #1, #2 and #3 launched by every rank
    in every entry. The NCCL node and the gloo nodes start at once
    (start_multinode, `started`), beside the cascade phase's entries.
    Returns the launches of every process's runs."""
    folder, one = records
    t_nccl, t_gloo = wait_nodes(started)
    load = lambda name: json.load(open(os.path.join(folder, name)))  # noqa: E731
    print(f"[multinode] started at once: one node of one NCCL rank, {t_nccl:.1f} s of process; "
          f"{MN_NODES} launcher nodes of one gloo rank on the card, {t_gloo:.1f} s of "
          f"processes")
    nodes = [load(f"gloo-rank{r}.json") for r in range(MN_NODES)]
    nccl = load("nccl-rank0.json")
    entries = [load(f"entries-rank{r}.json") for r in range(MN_NODES)]
    devices = [load(f"gloo-device{r}.json") for r in range(MN_NODES)] + [
        load("nccl-device0.json")]
    check([r["backend"] for r in nodes] == ["gloo"] * MN_NODES and nccl["backend"] == "nccl",
          f"backends {[r['backend'] for r in nodes]}, {nccl['backend']}")
    check([d["device"] for d in devices] == ["cuda:0"] * (MN_NODES + 1),
          f"the ranks' devices {devices}")
    add_shapes(shapes, [*nodes, nccl, *entries])
    launches = ddp_launches([*nodes, nccl])
    for e in entries:
        for k in COUNT_KEYS:
            launches[k] += sum(run["launches"][k] for run in e["runs"].values())

    check_world2(one, nodes)
    for kind, keys in (("pretrain", ("student", "teacher")), ("supervised", ("weights",))):
        for label, want in one[kind].items():
            n = nccl[kind][label]
            check(same_steps(n, want, keys + ("launches",)) and n.get("val") == want.get("val")
                  and all(n["steps"][-1][f"d_{k}"] == 0 for k in keys),
                  f"{label}: NCCL world 1 through the launcher is not bit-equal to world 1 "
                  f"without a group")
    ms = {label: [round(s["ms"], 1) for s in r["steps"]]
          for kind in ("pretrain", "supervised") for label, r in nccl[kind].items()}
    print(f"[multinode] NCCL world 1 through the launcher bit-equal to no group in every case; "
          f"step ms {ms}")

    for e in entries:
        for label, run in e["runs"].items():
            check(all(run["launches"][k] > 0 for k in ("conv3x3.hopper", "zslab.hopper",
                                                          "moments")),
                  f"{label} launched {run['launches']}")
    check(entries[0]["wrote"] and not entries[1]["wrote"],
          f"checkpoint writers: rank 0 {entries[0]['wrote']}, rank 1 {entries[1]['wrote']}")
    results = os.path.join(root, "results")
    pretrain_folder = os.path.join(results, TRAINER_DATASET, "pretrain_anatomask_B")
    with open(os.path.join(pretrain_folder, "pretrain_log.txt")) as f:
        log = f.read()
    check(os.path.isfile(os.path.join(pretrain_folder, "checkpoint_final.pt"))
          and "resumed at epoch 1" in log
          and re.findall(r"^epoch (\d+):", log, re.M) == ["0", "1"],
          f"the pretraining entries: {os.listdir(pretrain_folder)}, log {log[-400:]}")
    fold = os.path.join(results, SUP_DATASET, "STUNetTrainer_base_ft__ATKPlans__3d_fullres",
                        "fold_0")
    _, meta = ckpt_mod.load_checkpoint(os.path.join(fold, "checkpoint_final.npz"))
    with open(os.path.join(fold, "training_log.txt")) as f:
        check("resuming from" in f.read() and meta["current_epoch"] == 2,
              f"the training resume: epoch {meta['current_epoch']}")
    keys = load_json(os.path.join(root, "preprocessed", SUP_DATASET, "splits_final.json"))[0]["val"]
    check(all(e["predicted"] == keys[r::MN_NODES] * 2 for r, e in enumerate(entries)),
          f"validation cases: {[e['predicted'] for e in entries]} of {keys}, twice")
    with open(os.path.join(fold, "validation", "summary.json")) as f:
        summary = json.load(f)
    check(sorted(os.path.basename(c["prediction_file"]) for c in summary["metric_per_case"])
          == sorted(k + ".nii.gz" for k in keys)
          and math.isfinite(summary["foreground_mean"]["Dice"]),
          f"summary.json of {[c['prediction_file'] for c in summary['metric_per_case']]}")
    print(f"[multinode] entries through the launcher, rank 0's seconds "
          f"{ {k: round(v['seconds'], 1) for k, v in entries[0]['runs'].items()} }, rank 1's "
          f"{ {k: round(v['seconds'], 1) for k, v in entries[1]['runs'].items()} }; checkpoint "
          f"files written by rank 0 {entries[0]['wrote']}, by rank 1 {entries[1]['wrote']}; "
          f"validation cases rank 0 {entries[0]['predicted']}, rank 1 {entries[1]['predicted']}; "
          f"summary.json from rank 0, mean Dice {summary['foreground_mean']['Dice']}; launches "
          f"{launches}")
    return launches


def mark(phase, start=time.perf_counter()):
    """A [time] line: the seconds since the script started, after `phase`."""
    print(f"[time] {phase} ended at {time.perf_counter() - start:.1f} s")


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
    if sys.argv[1:2] == ["--multinode-rank"]:  # a process that the multinode phase launched
        multinode_rank_main(*sys.argv[2:])
        return 0
    if sys.argv[1:2] == ["--prepare"]:  # the process that main starts after the build
        prepare_main(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    smi = gpu_line()
    print(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = ("conv3x3", "moments", "zslab_conv", "norm_act")
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
    mark("build")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    work = tempfile.TemporaryDirectory()
    pretrained = os.path.join(work.name, "pretrain_checkpoint_final.pt")
    (conv_err, conv_rel, conv_step, conv_volume, conv_tile, conv_checked, k1_step,
     k1_infer) = conv_phase(gen)
    free_memory()
    stem_errs, stem_rows, stem_checked = stem_table(gen)
    conv_err, conv_rel = max(conv_err, stem_errs["conv3x3"][0]), max(conv_rel,
                                                                     stem_errs["conv3x3"][1])
    free_memory()
    zc_err, zc_rel, zc_step, zc_volume, zc_tile, zc_checked, zc_timed = zconcat_phase(
        gen, k1_step, k1_infer)
    zc_err, zc_rel = max(zc_err, stem_errs["zslab"][0]), max(zc_rel, stem_errs["zslab"][1])
    free_memory()
    (mom_err, mom_rel, mom_step, mom_volume, mom_tile, mom_checked,
     mom_timed) = moments_phase(gen)
    free_memory()
    na_tile, na_step = norm_act_phase(gen)
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
    block_errs, block_times, block_checked = block_gate_phase(gen)
    conv_err, conv_rel = (max(conv_err, block_errs["conv3x3"][0]),
                          max(conv_rel, block_errs["conv3x3"][1]))
    zc_err, zc_rel = max(zc_err, block_errs["zslab"][0]), max(zc_rel, block_errs["zslab"][1])
    mom_err, mom_rel = (max(mom_err, block_errs["moments"][0]),
                        max(mom_rel, block_errs["moments"][1]))
    block_tot = block_step_totals(k1_step, zc_timed, mom_timed, block_times)
    free_memory()
    # its own generator: the later phases draw as before
    fp32_errs, fp32_times, fp32_stem_rows, fp32_checked = fp32_gate_phase(
        torch.Generator(device="cuda").manual_seed(16))
    fp32_tot = fp32_totals(fp32_times)
    free_memory()
    mark("kernel phases")
    prep_dir = tempfile.TemporaryDirectory()
    prep = (start_prepare(prep_dir.name), prep_dir.name)

    tf32_defaults()  # PyTorch's own flags: the port's fp32 setup must turn TF32 off
    reference_phase()
    check_tf32_off("reference_phase (build_spark_model at float32)")
    print("[slice] PyTorch's default TF32 flags set back before the reference phase: its "
          "float32 models' setup turned TF32 off for cuDNN and cuBLAS")
    remat_phase()
    inference_reference_phase()
    free_memory()
    mark("reference phases")
    shapes = LaunchShapes()  # from here on, only the main paths launch kernels
    pretrain, bare_step_ms, _, dense_losses = slice_phase()
    free_memory()
    block_launches, _, _ = block_step_phase(bare_step_ms, dense_losses, shapes)
    free_memory()
    mark("slice and block step phases")
    fp32_pretrain, fp32_step_ms, _, _ = slice_phase(dtype="float32")
    free_memory()
    mark("fp32 step phase")
    inference = inference_phase()
    free_memory()
    mark("inference phase")
    fp32_volume = inference_phase(torch.float32, volumes=1)
    free_memory()
    mark("fp32 volume phase")
    trainer, fp32_trainer = trainer_phase(bare_step_ms, pretrained, fp32_step_ms)
    free_memory()
    mark("trainer phase")
    with tempfile.TemporaryDirectory() as root:
        files, predictor, ladder_data, case_tiles = files_phase(root)
    free_memory()
    mark("files phase")
    with tempfile.TemporaryDirectory() as root:
        supervised, plain_trainer, da5_trainer = supervised_phase(root, pretrained)
    work.cleanup()
    held = torch.cuda.memory_allocated()
    free_memory()
    left = torch.cuda.memory_allocated()
    print(f"[memory] allocated after the supervised phase: {held / 2**30:.2f} GiB ({held} "
          f"bytes); after gc.collect(): {left / 2**30:.2f} GiB ({left} bytes, the files "
          f"phase's predictor among it)")
    mark("supervised phase")
    h_pretrain, h_step_ms = h_step_phase()
    free_memory()
    mark("H step phase")
    with tempfile.TemporaryDirectory() as root:
        h_trainer, h_final = h_trainer_phase(root, h_step_ms)
        free_memory()
        h_finetune = h_transfer_phase(root, h_final)
    free_memory()
    mark("H trainer and transfer phases")
    checked = {k: v | sup_checked[k] | h_checked[k] | block_checked[k]
               | stem_checked.get(k, set()) | fp32_checked.get(k, set())
               for k, v in (("conv3x3", conv_checked), ("zslab", zc_checked),
                            ("moments", mom_checked))}
    cli_launches, cli_errs, cli_step, cli_case = cli_phase(prep, gen, checked, shapes)
    shutil.rmtree(os.path.join(prep_dir.name, "cli"))
    free_memory()
    mark("cli phase")
    with shapes.paused():  # the gates draw from `gen` in the phases' order
        casc_gates = cascade_gate_phase(gen, checked)
    free_memory()
    with tempfile.TemporaryDirectory() as root:
        ddp_launches, ddp_errs, ddp_pre, ddp_sup, ddp_records = ddp_phase(root, gen, checked,
                                                                          shapes)
        free_memory()
        mark("cascade gates and ddp phase")
        nodes = start_multinode(root, ddp_records[0])
        casc_launches, casc_errs, casc_step, casc_case = cascade_phase(prep, casc_gates, shapes)
        check(prep[0].wait() == 0, f"the preparing process exited {prep[0].returncode}")
        prep_dir.cleanup()
        free_memory()
        mark("cascade phase (the multinode nodes beside its entries)")
        multinode_launches = multinode_phase(root, ddp_records, shapes, nodes)
    mark("multinode phase")
    for errs in (cli_errs, casc_errs, ddp_errs):
        conv_err, conv_rel = max(conv_err, errs["conv3x3"][0]), max(conv_rel,
                                                                    errs["conv3x3"][1])
        zc_err, zc_rel = max(zc_err, errs["zslab"][0]), max(zc_rel, errs["zslab"][1])
        mom_err, mom_rel = max(mom_err, errs["moments"][0]), max(mom_rel, errs["moments"][1])
    for label, seen in (("conv3x3", shapes.conv), ("zslab", shapes.zslab),
                        ("moments", shapes.moments)):
        check(seen <= checked[label],
              f"{label} launches at unchecked shapes: {sorted(seen - checked[label])}")
    print(f"[paths] every launch ran at a checked shape: {len(shapes.conv)} kernel #1, "
          f"{len(shapes.zslab)} kernel #2, {len(shapes.moments)} moments shapes")
    ladder_phase(predictor, ladder_data)  # tile batch 2 launches at B = 16: no path's
    mark("ladder phase")

    runs = {"pretrain": pretrain, "inference": inference, "pretrain_trainer": trainer,
            "files": files, "supervised": supervised, "plain_trainer": plain_trainer,
            "da5_trainer": da5_trainer, "pretrain_h": h_pretrain,
            "pretrain_h_trainer": h_trainer, "finetune_h": h_finetune, "cli": cli_launches,
            "cascade": casc_launches, "ddp": ddp_launches, "multinode": multinode_launches,
            "block_step": block_launches, "fp32_pretrain": fp32_pretrain,
            "fp32_volume": fp32_volume, "fp32_trainer": fp32_trainer}
    for path, c in runs.items():
        check(c["conv3x3.simple"] == 0 and c["zslab.simple"] == 0,
              f"{path}: the simple variant launched ({c})")
    print(f"[paths] no path launched the simple variant ({len(runs)} runs)")
    per = ("one pretraining step (B = 4), one inference volume (18 STUNet-B tiles at B = 8), "
           f"one case of the file path ({case_tiles} PlainConvUNet tiles at B = 8), one "
           "STUNet-B finetuning step and one ATKTrainer PlainConvUNet step (B = 2), one "
           "STUNet-H pretraining step (B = 4 in two microbatches, remat) and one "
           "STUNetTrainer_huge step (B = 2, remat), one step of the planner's PlainConvUNet "
           "(one input channel, B = 2) and one test case and fold of the command line's predict "
           f"({math.ceil(tiles_of((1, *CLI_TEST[0][1])) / 2)} forwards at B = {CLI_TILE_BATCH}), "
           f"one step of the cascade's PlainConvUNet ({CASCADE_IN} input channels, B = 2) and "
           f"one cascade test case and fold "
           f"({cascade_case_forwards()} forwards at "
           f"B = {CLI_TILE_BATCH}); by_path splits them; launches_by_path "
           "counts every launch of each path's run, the PretrainTrainer runs', the "
           "supervised runs' (training, resume, final validation, checkpoint round trip, bare "
           "steps), the ATKTrainer steps', the H phases' (bare, profiled and ride-along "
           "steps; the H trainer's run; the H finetuning steps), the ATKTrainerDA5 steps', "
           "the command line's (every entry, and the installed model's check), the cascade's "
           "(every entry), the ddp phase's (the NCCL rank that launch spawns at world 1) and the "
           "multinode phase's (every launcher rank's steps, at world 2 over gloo and at world 1 "
           "over NCCL, and its entries' runs) too; ddp_pretrain_rank_step is one rank's "
           f"pretraining step at world {DDP_WORLD} ({DDP_ACCUM} microbatches at B = "
           f"{DDP_MICRO}), ddp_supervised_rank_step one rank's STUNet-B finetuning step (B = 1), "
           "at the launch shapes of the multinode phase's gloo ranks; "
           "block_step is one pretraining step (B = 4) with ATK_BLOCK_SPARSE=1: stages 0-1 on "
           f"{BLOCKS} blocks (kernel #2 at padding 0, kernel #1's dx at padding 2, the block "
           "norms' moments), the rest as the step's")

    def case(tile):  # one PlainConvUNet tile's totals -> one case's
        return {k: case_tiles * v for k, v in tile.items()}

    def launches(kernel):
        return {path: kernel_launches(c, kernel) for path, c in runs.items()}

    def by_variant(kernel):
        return {v: sum(c[f"{kernel}.{v}"] for c in runs.values()) for v in VARIANTS}

    zslab_record = kernel_record(
        "conv3d_zslab", "anatomask_torch/csrc/zslab_conv.cu",
        "anatomask_tpu/ops/pallas_zslab_conv.py:142", launches("zslab"), zc_err, zc_rel,
        {"pretrain_step": zc_step, "inference_volume": zc_volume, "files_case": case(zc_tile),
         "supervised_step": sup_step["zslab"], "plain_trainer_step": plain_step["zslab"],
         "pretrain_h_step": h_step["zslab"], "finetune_h_step": h_sup["zslab"],
         "cli_plain_step": cli_step["zslab"], "cli_case": cli_case["zslab"],
         "cascade_step": casc_step["zslab"], "cascade_case": casc_case["zslab"],
         "ddp_pretrain_rank_step": ddp_pre["zslab"], "ddp_supervised_rank_step": ddp_sup["zslab"],
         "block_step": block_tot["zslab"]},
        per + "; the main paths' per-tap forwards through conv3d_zconcat", by_variant("zslab"))
    # the stem variant: its launches in each path's run, and the stem table's
    # rows (both roundings timed at each path's stem shape)
    stem_per = ("ms: kernel #2's per-tap stem at the path's stem shape (once_ms: kernel #1's "
                "once-rounded one), bound_ms its bound (bytes: x read and y written once), "
                "share = bound_ms / ms, simple_ms the simple variant it replaced, through its C "
                "entry point")
    zslab_record["stem"] = {"launches_by_path": {p: c["zslab.stem"] for p, c in runs.items()},
                            "per": stem_per, "by_shape": stem_rows}
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
         "cli_case": cli_case["moments"], "cascade_step": casc_step["moments"],
         "cascade_case": casc_case["moments"], "ddp_pretrain_rank_step": ddp_pre["moments"],
         "ddp_supervised_rank_step": ddp_sup["moments"],
         "block_step": block_tot["moments"]},
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
                       "cli_plain_step": cli_step["conv3x3"], "cli_case": cli_case["conv3x3"],
                       "cascade_step": casc_step["conv3x3"],
                       "cascade_case": casc_case["conv3x3"],
                       "ddp_pretrain_rank_step": ddp_pre["conv3x3"],
                       "ddp_supervised_rank_step": ddp_sup["conv3x3"],
                       "block_step": block_tot["conv3x3"]},
                      per,
                      by_variant("conv3x3")),
        moments_record,
        zslab_record,
        kernel_record(
            "norm_act", "anatomask_torch/csrc/norm_act.cu", None,
            {"inference_volume": VOLUMES * TILES * TILE_NORM_ACT,
             "pretrain_step": STEPS * STEP_NORM_ACT}, 0.0, 0.0,
            {"inference_volume": {k: TILES * v for k, v in na_tile.items()},
             "pretrain_step": na_step},
            "the one-pass norm epilogue, bit-equal to its plain version: ms the kernel (CUDA "
            "events), plain_ms and library_ms the op sequence it replaces (no one PyTorch call "
            "computes it), bound_ms its bytes over 3.35 TB/s; a volume's 18 tiles of 22 calls "
            "at B = 8 (a block's norm1 and norm2), a pretraining step's teacher decoder's 8 "
            "bare calls at B = 4"),
    ]
    # the float32 path's variant of kernels #1 and #2: its launches in the
    # fp32 runs (the B step's 5, the volumes, the PretrainTrainer run), its
    # times over one B step and one volume from the fp32 gates
    fp32_per = ("the tf32x3 variant's launches on the float32 path: one pretraining step (B = "
                "4: two forwards, the student's dx) and one inference volume (18 STUNet-B tiles "
                "at B = 8); launches_by_path counts the fp32 step phase's 5 steps, its 2 "
                "volumes (one a warm-up) and the float32 PretrainTrainer run; simple_ms is the "
                "simple variant it replaced at the same shapes (its C entry point), pipe_ms the "
                "products at the FP32 pipe's 67 TFLOP/s, bound_ms three TF32 products a term at "
                "495 TFLOP/s (or the bytes at 3.35 TB/s); library_ms F.conv3d in fp32 with TF32 "
                "off")
    fp32_runs = {"fp32_pretrain": fp32_pretrain, "fp32_volume": fp32_volume,
                 "fp32_trainer": fp32_trainer}
    for kernel, name, source, replaces in (
            ("conv3x3", "conv3d_3x3.tf32x3", "anatomask_torch/csrc/conv3x3.cu",
             "anatomask_tpu/ops/pallas_conv.py:108"),
            ("zslab", "conv3d_zslab.tf32x3", "anatomask_torch/csrc/zslab_conv.cu",
             "anatomask_tpu/ops/pallas_zslab_conv.py:142")):
        paths = {p: fp32_tot[(p, kernel)] for p in FP32_PATHS}
        rec = kernel_record(name, source, replaces,
                            {p: c[f"{kernel}.tf32x3"] for p, c in fp32_runs.items()},
                            *fp32_errs[kernel], paths, fp32_per,
                            {v: sum(c[f"{kernel}.{v}"] for c in fp32_runs.values())
                             for v in VARIANTS})
        rec["simple_ms"] = sum(t["simple_ms"] for t in paths.values())
        rec["pipe_ms"] = sum(t["pipe_ms"] for t in paths.values())
        for p, t in paths.items():
            rec["by_path"][p].update(simple_ms=t["simple_ms"], pipe_ms=t["pipe_ms"])
        kernels.append(rec)
    # the fp32 stem (kernel #2's stem variant in float32, on the FP32 pipe):
    # its launches in the fp32 runs, its times over one B step and one volume
    # from the fp32 gates, and its rows at every fp32 stem shape gated
    paths = {p: fp32_tot[(p, "stem")] for p in FP32_PATHS}
    rec = kernel_record(
        "conv3d_zslab.stem_fp32", "anatomask_torch/csrc/conv3x3_stem.cuh",
        "anatomask_tpu/ops/pallas_zslab_conv.py:142",
        {p: c["zslab.stem"] for p, c in fp32_runs.items()}, *fp32_errs["stem"], paths,
        "the fp32 stem's launches on the float32 path (kernel #2's stem variant in fp32: "
        "1 -> 32, two a pretraining step at B = 4, one a tile at B = 8), launches_by_path as "
        "the tf32x3 records'; simple_ms the simple variant it replaced (its C entry point), "
        "pipe_ms the products at the FP32 pipe's 67 TFLOP/s, bound_ms the bytes at 3.35 TB/s "
        "(or three TF32 products a term at 495 TFLOP/s); library_ms F.conv3d in fp32 with TF32 "
        "off; by_shape: each fp32 stem shape gated (once_ms: kernel #1's once-rounded stem)")
    rec["simple_ms"] = sum(t["simple_ms"] for t in paths.values())
    rec["pipe_ms"] = sum(t["pipe_ms"] for t in paths.values())
    rec["once_max_abs_err"], rec["once_max_rel_err"] = fp32_errs["stem_once"]
    rec["by_shape"] = fp32_stem_rows
    kernels.append(rec)
    kernels[0]["stem"] = {"launches_by_path": {p: c["conv3x3.stem"] for p, c in runs.items()},
                          "once_ms_by_shape": {p: r["once_ms"] for p, r in stem_rows.items()},
                          "once_plain_ms_by_shape": {p: r["once_plain_ms"]
                                                     for p, r in stem_rows.items()},
                          "library_ms_by_shape": {p: r["library_ms"]
                                                  for p, r in stem_rows.items()}}
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

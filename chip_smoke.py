#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (anatomask_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which raises on a failed check:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/conv3x3.cu and csrc/moments.cu for sm_90a from the
   checkout's sources, one nvcc each, both at once;
3. conv kernel: at every call site of the stride-1 3x3x3 conv on both main
   paths, the kernel against its plain PyTorch version on the card. For the
   pretraining step: forward and dx (bf16 at B = 1 through the autograd
   Function and at the step's B = 4, relative max error <= 1e-2; fp32
   without TF32 on a few shapes, <= 1e-5), and at B = 4 its time beside the
   bound, the plain version's time and F.conv3d's (a yardstick only; the port
   never calls it for this conv). For inference: forward at the tile
   forward's B = 8 (the 8 mirror flips), <= 1e-2, and the same times;
4. moments kernel: at every instance-norm shape of both paths (the step's
   masked and plain norms at B = 4, inference's at B = 8), bf16 and fp32, the
   kernel against its plain version, |diff| / sum|x| <= 1e-5 per (sample,
   channel), and in bf16 its time beside the bound, the plain version's and
   one torch.var_mean call's (a yardstick only); then the same check on four
   shapes off the main paths that take the kernel's other code paths;
5. references: a tiny SparK and a tiny STUNet (through both sliding-window
   paths) in fp32 on the card against the same models on the CPU, rel.
   error <= 1e-4;
6. pretraining: the AnatoMask pretraining step at full STUNet-B width (patch
   112x112x128, batch 4, mask ratio 0.6, bf16, decoder width 512) for 5
   steps, checking finite losses, the hard masks, 50 conv and 44 moments
   launches a step and the EMA law, and timing the last 3 steps;
7. inference: bench_inference.py's configuration at full width through the
   Predictor: STUNet-B (6 stages, 1 input channel, 3 classes), a
   240x240x155 volume, patch 128^3, step 0.5, 18 tiles, 8-flip mirror TTA,
   tile batch 1, bf16; 3 volumes, the first a warm-up, checking finite
   logits of shape (3, 240, 240, 155) and 17 x 18 conv and 22 x 18 moments
   launches a volume.

Each main path (6, 7) runs with the launch counts set to 0 just before it
and read just after, and every launch it makes must be at a shape that
phases 3 and 4 held against the plain version. The last three lines of
standard output are the nvidia-smi line, one JSON object {"kernels": [...]},
and {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as fn

from anatomask_torch.inference.predictor import Predictor
from anatomask_torch.inference.sliding_window import (compute_steps_for_sliding_window,
                                                      make_tile_predictor,
                                                      sliding_window_predict,
                                                      sliding_window_predict_device_resident)
from anatomask_torch.models.build import build_network_from_plans
from anatomask_torch.models.stunet import STUNet
from anatomask_torch.ops import _build
from anatomask_torch.ops import conv3x3 as conv_mod
from anatomask_torch.ops import moments as moments_mod
from anatomask_torch.ops.conv3x3 import (conv3d_3x3, conv3d_3x3_forward, conv3d_3x3_plain,
                                         flip_weight)
from anatomask_torch.ops.moments import row_moments, row_moments_forward, row_moments_plain
from anatomask_torch.plans.plans_handler import PlansManager
from anatomask_torch.ssl.pretrain import (PretrainConfig, anatomask_train_step,
                                          build_spark_model, make_optimizer, make_teacher)
from anatomask_torch.ssl.sparse import mask_to_resolution
from anatomask_torch.ssl.spark import random_keep_mask

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
STEPS, WARMUP = 5, 2
FMAP, LEN_KEEP = (7, 7, 8), 157  # the step's patch grid and visible patches
# bench_inference.py's configuration
VOLUME, NUM_CLASSES, PATCH = (240, 240, 155), 3, (128, 128, 128)
TILES, VOLUMES = 18, 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(f, reps):
    f()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        f()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def time_site(C, F, vol, gen, batch):
    """At a main path's batch in bf16: the kernel against the plain version
    (relative max error <= 1e-2), then the ms of the kernel, the plain version
    and F.conv3d. Returns (ms, plain ms, F.conv3d ms), (max abs err, rel err)."""
    x, w = conv_inputs(C, F, vol, batch, torch.bfloat16, gen)
    y_k, y_p = conv3d_3x3_forward(x, w), conv3d_3x3_plain(x, w)
    err = rel_err(y_k, y_p)
    check(math.isfinite(err) and err <= 1e-2,
          f"kernel vs plain {C}->{F} @{vol} B={batch}: rel error {err} > 1e-2")
    abs_err = (y_k.float() - y_p.float()).abs().max().item()
    del y_k, y_p
    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d memory
    wc = w.permute(4, 3, 0, 1, 2).contiguous()
    ms = time_ms(lambda: conv3d_3x3_forward(x, w), 3)
    plain = time_ms(lambda: conv3d_3x3_plain(x, w), 1)
    lib = time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 3)
    return (ms, plain, lib), (abs_err, err)


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
    """Returns max abs err, max rel err, totals for one pretraining step and
    totals for one inference volume, and the launch shapes it checked."""
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
    timed = {}
    for key in shapes:
        timed[key], (a, r) = time_site(*key, gen, BATCH)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[conv] bf16 {key[0]:>3}->{key[1]:<3} @{key[2]} B={BATCH}: fwd rel err {r:.3e}")
    torch.cuda.empty_cache()
    infer = {}
    for _, C, F, vol in INFER_SITES:
        if (C, F, vol) not in infer:
            infer[(C, F, vol)], (a, r) = time_site(C, F, vol, gen, TTA_BATCH)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
            print(f"[conv] bf16 {C:>4}->{F:<3} @{vol} B={TTA_BATCH}: fwd rel err {r:.3e}")
            torch.cuda.empty_cache()
    step = dict.fromkeys(TOTAL_KEYS, 0.0)
    for name, C, F, vol in SITES:
        # per step: teacher and student forwards, and the student's dx except
        # at the stem, whose input carries no gradient
        for key, n in (((C, F, vol), 2), ((F, C, vol), 0 if name == "enc0.conv1" else 1)):
            add_totals(step, n, *timed[key], *bound_ms(*key))
    volume = dict.fromkeys(TOTAL_KEYS, 0.0)
    for _, C, F, vol in INFER_SITES:  # per volume: one forward a tile
        add_totals(volume, TILES, *infer[(C, F, vol)], *bound_ms(C, F, vol, TTA_BATCH))
    print_timed("step", BATCH, timed)
    print_timed("inference", TTA_BATCH, infer)
    checked = ({(BATCH, *vol, C, F) for C, F, vol in timed}
               | {(TTA_BATCH, *vol, C, F) for C, F, vol in infer})
    return max_abs, max_rel, step, volume, checked


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


def moments_err(x, mask):
    """Kernel against plain: max over (sample, channel) of |diff| / sum m|x|
    for the sum and |diff| / sum m x^2 for the sum of squares."""
    s_k, ss_k = row_moments_forward(x, mask)
    s_p, ss_p = row_moments_plain(x, mask)
    scale = row_moments_plain(x.abs(), mask)[0].clamp_min(1e-30)
    torch.cuda.synchronize()
    rel = max(((s_k - s_p).abs() / scale).max().item(),
              ((ss_k - ss_p).abs() / ss_p.clamp_min(1e-30)).max().item())
    abs_err = max((s_k - s_p).abs().max().item(), (ss_k - ss_p).abs().max().item())
    return abs_err, rel


def moments_phase(gen):
    """Returns max abs err, max rel err, totals for one pretraining step and
    for one inference volume, and the launch shapes it checked."""
    shapes = {}
    for batch, norms in ((BATCH, PRETRAIN_NORMS), (TTA_BATCH, INFER_NORMS)):
        for name, vol, C, masked in norms:
            shapes.setdefault((batch, vol, C, masked), []).append(name)
    max_abs, max_rel, timed = 0.0, 0.0, {}
    for key, users in shapes.items():
        batch, vol, C, masked = key
        for dtype in (torch.bfloat16, torch.float32):
            x, mask = moments_inputs(batch, vol, C, masked, dtype, gen)
            a, r = moments_err(x, mask)
            check(math.isfinite(r) and r <= 1e-5,
                  f"moments kernel vs plain {key} {dtype}: rel error {r} > 1e-5")
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
            print(f"[moments] {str(dtype)[6:]:>8} B={batch} {vol} C={C:<3} "
                  f"{'masked' if masked else 'plain '}: rel err {r:.3e} ({','.join(users)})")
            if dtype == torch.bfloat16:
                ms = time_ms(lambda: row_moments_forward(x, mask), 20)
                plain = time_ms(lambda: row_moments_plain(x, mask), 3)
                lib = time_ms(lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0), 5)
                visible = int(mask.sum()) if masked else batch * math.prod(vol)
                timed[key] = (ms, plain, lib, visible)
            del x, mask
        torch.cuda.empty_cache()
    # off the main paths: element loads (C not a multiple of 16 bytes), more
    # channels than one block's 256 vector columns, a ragged last chunk
    for batch, vol, C, masked in ((2, (5, 6, 7), 3, True), (3, (9, 9, 9), 12, False),
                                  (2, (7, 7, 8), 4096, True), (1, (33, 35, 37), 8, False)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((batch, *vol, C), generator=gen, device="cuda") + 0.5).to(dtype)
            mask = (torch.rand((batch, *vol), generator=gen, device="cuda") > 0.4
                    if masked else None)
            a, r = moments_err(x, mask)
            check(math.isfinite(r) and r <= 1e-5,
                  f"moments kernel vs plain {(batch, vol, C, masked)} {dtype}: rel error {r}")
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
            print(f"[moments] {str(dtype)[6:]:>8} B={batch} {vol} C={C:<4} "
                  f"{'masked' if masked else 'plain '}: rel err {r:.3e} (edge case)")
    step = dict.fromkeys(TOTAL_KEYS, 0.0)
    for name, vol, C, masked in PRETRAIN_NORMS:  # teacher and student forwards
        key = (BATCH, vol, C, masked)
        add_totals(step, 2, *timed[key][:3], *moments_bound_ms(*key, timed[key][3]))
    volume = dict.fromkeys(TOTAL_KEYS, 0.0)
    for name, vol, C, masked in INFER_NORMS:  # one forward a tile
        key = (TTA_BATCH, vol, C, masked)
        add_totals(volume, TILES, *timed[key][:3], *moments_bound_ms(*key, timed[key][3]))
    for (batch, vol, C, masked), (ms, plain, lib, visible) in timed.items():
        flop_ms, byte_ms = moments_bound_ms(batch, vol, C, masked, visible)
        gbps = byte_ms * PEAK_BYTES / 1e3 / ms / 1e6
        print(f"[moments] B={batch} {vol} C={C:<3} {'masked' if masked else 'plain '}: "
              f"{ms:.4f} ms ({gbps:.0f} GB/s), bound {max(flop_ms, byte_ms):.4f} ms "
              f"({'bytes' if byte_ms >= flop_ms else 'operations'}), plain {plain:.4f} ms, "
              f"var_mean {lib:.4f} ms")
    checked = {(b, *vol, C, masked) for b, vol, C, masked in timed}
    return max_abs, max_rel, step, volume, checked


class LaunchShapes:
    """Records the shape of every kernel launch while it is on: the conv's
    (B, X, Y, Z, C, F) and the moments' (B, X, Y, Z, C, masked). It wraps each
    module's launch function and leaves the launch counts to the wrappers."""

    def __init__(self):
        self.conv, self.moments = set(), set()
        conv_launch, moments_launch = conv_mod._launch, moments_mod._launch

        def conv(x, w):
            self.conv.add((*x.shape, w.shape[-1]))
            return conv_launch(x, w)

        def moments(x, mask):
            self.moments.add((*x.shape, mask is not None))
            return moments_launch(x, mask)

        conv_mod._launch, moments_mod._launch = conv, moments


def reference_phase():
    """A tiny SparK in fp32: the card (kernels) against the CPU (plain)."""
    cfg = PretrainConfig(patch_size=(32, 32, 32), encoder_dims=(4, 8, 16, 32, 64),
                         compute_dtype="float32")
    cpu = build_spark_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(6)
    x = torch.rand((2, 1, 32, 32, 32), generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    mask = random_keep_mask(2, cpu.fmap, cpu.len_keep, gen, device="cpu")
    with torch.no_grad():
        _, rec_c = cpu(x, mask)
        _, rec_g = gpu(x.cuda(), mask.cuda())
    err = rel_err(rec_g.cpu(), rec_c)
    check(math.isfinite(err) and err <= 1e-4, f"tiny SparK card vs CPU rel err {err}")
    print(f"[slice] tiny SparK fp32, card vs CPU: rec rel err {err:.3e}")
    return err


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
    conv3d_3x3.launches = row_moments.launches = 0
    for step in range(STEPS):
        before = conv3d_3x3.launches, row_moments.launches
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
        n_conv = conv3d_3x3.launches - before[0]
        n_mom = row_moments.launches - before[1]
        check(n_conv == 50, f"step {step}: {n_conv} conv launches, expected 50")
        # two forwards (teacher, student) of 22 norms; the backward is elementwise
        check(n_mom == 2 * len(PRETRAIN_NORMS),
              f"step {step}: {n_mom} moments launches, expected {2 * len(PRETRAIN_NORMS)}")
        moved = False
        for e, o, p in zip(teacher.parameters(), old, student.parameters()):
            want = o + 0.001 * (p.detach() - o)
            check((e - want).abs().max().item() <= 1e-6, f"step {step}: EMA law broken")
            moved = moved or not torch.equal(e, o)
        check(moved, f"step {step}: the teacher did not move")
        print(f"[slice] step {step}: loss {losses[-1]:.6f}, {times[-1]:.1f} ms, "
              f"launches conv {n_conv}, moments {n_mom}")
    launches = conv3d_3x3.launches, row_moments.launches
    step_ms = statistics.median(times[WARMUP:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] step {step_ms:.1f} ms (median of {STEPS - WARMUP}), "
          f"{BATCH / step_ms * 1e3:.3f} patches/s, peak memory {peak / 2**30:.2f} GiB, "
          f"{launches[0]} conv and {launches[1]} moments launches in {STEPS} steps")
    return launches


def inference_reference_phase():
    """A tiny STUNet in fp32 through both sliding-window paths (mirror TTA,
    8 tiles): the card (kernels) against the CPU (plain)."""
    # pools chosen so that the bottom level keeps 4x4x8 voxels of a 32^3 tile
    pools = [(2, 2, 2), (2, 2, 2), (2, 2, 1), (1, 1, 1), (1, 1, 1)]
    cpu = STUNet(1, 3, dims=(4, 8, 16, 16, 32, 32), pool_op_kernel_sizes=pools,
                 deep_supervision=False, generator=torch.Generator().manual_seed(7)).eval()
    gpu = copy.deepcopy(cpu).to("cuda")
    data = np.random.RandomState(8).rand(1, 45, 40, 33).astype(np.float32)

    def tile_fn(net):
        return make_tile_predictor(
            lambda x: net(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1), (0, 1, 2))

    kw = dict(tile_size=(32, 32, 32), num_output_channels=3, tile_batch_size=3)
    ref = sliding_window_predict_device_resident(data, tile_fn(cpu), device="cpu", **kw)
    errs = [float(np.abs(got - ref).max() / np.abs(ref).max())
            for got in (sliding_window_predict_device_resident(data, tile_fn(gpu), **kw),
                        sliding_window_predict(data, tile_fn(gpu), **kw))]
    check(all(math.isfinite(e) and e <= 1e-4 for e in errs),
          f"tiny STUNet card vs CPU rel errs {errs}")
    print(f"[inference] tiny STUNet fp32, card vs CPU: rel err device-resident "
          f"{errs[0]:.3e}, streaming {errs[1]:.3e}")
    return max(errs)


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
    conv3d_3x3.launches = row_moments.launches = 0
    for v in range(VOLUMES):
        before = conv3d_3x3.launches, row_moments.launches
        t0 = time.perf_counter()
        logits = predictor.predict_sliding_window_return_logits(data)
        times.append(time.perf_counter() - t0)
        n_conv = conv3d_3x3.launches - before[0]
        n_mom = row_moments.launches - before[1]
        check(logits.shape == (NUM_CLASSES, *VOLUME), f"volume {v}: logits {logits.shape}")
        check(bool(np.isfinite(logits).all()), f"volume {v}: non-finite logits")
        check(n_conv == len(INFER_SITES) * TILES,
              f"volume {v}: {n_conv} conv launches, expected {len(INFER_SITES) * TILES}")
        check(n_mom == len(INFER_NORMS) * TILES,
              f"volume {v}: {n_mom} moments launches, expected {len(INFER_NORMS) * TILES}")
        first = logits if first is None else first
        print(f"[inference] volume {v}: {times[-1]:.3f} s, launches conv {n_conv}, moments "
              f"{n_mom}, logits mean {float(logits.mean()):.6f}, max |diff| to volume 0 "
              f"{float(np.abs(logits - first).max()):.3e}")
    launches = conv3d_3x3.launches, row_moments.launches
    volume_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[inference] {volume_s:.3f} s a volume (median of {VOLUMES - 1}), "
          f"{1 / volume_s:.4f} volumes/s, {TILES / volume_s:.2f} tiles/s, peak memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes), {launches[0]} conv and {launches[1]} "
          f"moments launches in {VOLUMES} volumes")
    return launches


def kernel_record(name, source, replaces, launches, max_abs, max_rel, step, volume, per):
    paths = {"pretrain_step": step, "inference_volume": volume}
    both = {k: step[k] + volume[k] for k in TOTAL_KEYS}
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches[0] + launches[1],
        launches_by_path={"pretrain": launches[0], "inference": launches[1]},
        max_abs_err=max_abs, max_rel_err=max_rel, checked=True,
        ms=both["ms"], plain_ms=both["plain_ms"], bound_ms=both["bound_ms"],
        bound_by="operations" if both["flop_ms"] >= both["byte_ms"] else "bytes",
        library_ms=both["library_ms"],
        per=per, by_path={p: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
                          for p, t in paths.items()})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    smi = gpu_line()
    print(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    names = ("conv3x3", "moments")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source, all at once
        for lib in pool.map(_build.build, names):
            print(f"[build] {lib.name}")
    for name in names:
        _build.load(name)
    print(f"[build] csrc/{{{','.join(names)}}}.cu for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name in names:
        for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    conv_err, conv_rel, conv_step, conv_volume, conv_checked = conv_phase(gen)
    mom_err, mom_rel, mom_step, mom_volume, mom_checked = moments_phase(gen)
    torch.cuda.empty_cache()

    reference_phase()
    inference_reference_phase()
    torch.cuda.empty_cache()
    shapes = LaunchShapes()  # from here on, only the main paths launch kernels
    pretrain = slice_phase()
    torch.cuda.empty_cache()
    inference = inference_phase()
    check(shapes.conv <= conv_checked,
          f"conv launches at unchecked shapes: {sorted(shapes.conv - conv_checked)}")
    check(shapes.moments <= mom_checked,
          f"moments launches at unchecked shapes: {sorted(shapes.moments - mom_checked)}")
    print(f"[paths] every launch ran at a checked shape: {len(shapes.conv)} conv, "
          f"{len(shapes.moments)} moments shapes")

    per = ("one pretraining step (B = 4) plus one inference volume (18 tiles at B = 8); "
           "by_path splits them")
    kernels = [
        kernel_record("conv3d_3x3", "anatomask_torch/csrc/conv3x3.cu",
                      "anatomask_tpu/ops/pallas_conv.py:108", (pretrain[0], inference[0]),
                      conv_err, conv_rel, conv_step, conv_volume, per),
        kernel_record("row_moments", "anatomask_torch/csrc/moments.cu",
                      "probes/probe_rowstats.py:53", (pretrain[1], inference[1]),
                      mom_err, mom_rel, mom_step, mom_volume, per),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (anatomask_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each of which raises on a failed check:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile csrc/conv3x3.cu for sm_90a from the checkout's sources;
3. kernel: at every main-path call site of the stride-1 3x3x3 conv, the kernel
   against its plain PyTorch version on the card, forward and dx (bf16 at
   B = 1 through the autograd Function and at the main path's B = 4,
   relative max error <= 1e-2; fp32 without TF32 on a few shapes, <= 1e-5),
   and at B = 4 its time beside the bound, the plain version's time and
   F.conv3d's (a yardstick only; the port never calls it for this conv);
4. slice: a tiny SparK in fp32 on the card against the same model on the CPU,
   then the AnatoMask pretraining step at full STUNet-B width (patch
   112x112x128, batch 4, mask ratio 0.6, bf16, decoder width 512) for 5 steps,
   checking finite losses, the hard masks, 50 kernel launches a step and the
   EMA law, and timing the last 3 steps.

The last three lines of standard output are the nvidia-smi line, one JSON
object {"kernels": [...]}, and {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as fn

from anatomask_torch.ops import _build
from anatomask_torch.ops.conv3x3 import (conv3d_3x3, conv3d_3x3_forward, conv3d_3x3_plain,
                                         flip_weight)
from anatomask_torch.ssl.pretrain import (PretrainConfig, anatomask_train_step,
                                          build_spark_model, make_optimizer, make_teacher)
from anatomask_torch.ssl.spark import random_keep_mask

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
BATCH = 4
# (call site, C, F, (X, Y, Z)) of every stride-1 3x3x3 conv in one forward of
# the main path: 6 in the encoder, 3 densify projections, 8 in the decoder
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
STEPS, WARMUP = 5, 2


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


def time_site(C, F, vol, gen):
    """At the main path's B = 4 in bf16: the kernel against the plain version
    (relative max error <= 1e-2), then the ms of the kernel, the plain version
    and F.conv3d. Returns (ms, plain ms, F.conv3d ms), (max abs err, rel err)."""
    x, w = conv_inputs(C, F, vol, BATCH, torch.bfloat16, gen)
    y_k, y_p = conv3d_3x3_forward(x, w), conv3d_3x3_plain(x, w)
    err = rel_err(y_k, y_p)
    check(math.isfinite(err) and err <= 1e-2,
          f"kernel vs plain {C}->{F} @{vol} B={BATCH}: rel error {err} > 1e-2")
    abs_err = (y_k.float() - y_p.float()).abs().max().item()
    del y_k, y_p
    xc = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels_last_3d memory
    wc = w.permute(4, 3, 0, 1, 2).contiguous()
    ms = time_ms(lambda: conv3d_3x3_forward(x, w), 3)
    plain = time_ms(lambda: conv3d_3x3_plain(x, w), 1)
    lib = time_ms(lambda: fn.conv3d(xc, wc, None, 1, 1), 3)
    return (ms, plain, lib), (abs_err, err)


def kernel_phase(gen):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_abs, max_rel = 0.0, 0.0
    shapes = {}
    for name, C, F, vol in SITES:
        for key in ((C, F, vol), (F, C, vol)):  # forward, and the dx conv
            shapes.setdefault(key, []).append(name)
    for (C, F, vol), users in shapes.items():
        a, r = check_site(C, F, vol, torch.bfloat16, gen, 1e-2)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[kernel] bf16 {C:>3}->{F:<3} @{vol}: fwd+dx rel err {r:.3e} ({','.join(users)})")
    for C, F, vol in [(1, 32, (32, 32, 32)), (64, 64, (32, 32, 32)), (512, 512, (7, 7, 8)),
                      (256, 128, (28, 28, 32))]:
        _, r = check_site(C, F, vol, torch.float32, gen, 1e-5)
        print(f"[kernel] fp32 {C:>3}->{F:<3} @{vol}: fwd+dx rel err {r:.3e}")
    timed = {}
    for key in shapes:
        timed[key], (a, r) = time_site(*key, gen)
        max_abs, max_rel = max(max_abs, a), max(max_rel, r)
        print(f"[kernel] bf16 {key[0]:>3}->{key[1]:<3} @{key[2]} B={BATCH}: fwd rel err {r:.3e}")
    torch.cuda.empty_cache()
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flop_ms=0.0, byte_ms=0.0, bound_ms=0.0)
    for name, C, F, vol in SITES:
        # per step: teacher and student forwards, and the student's dx except
        # at the stem, whose input carries no gradient
        for key, n in (((C, F, vol), 2), ((F, C, vol), 0 if name == "enc0.conv1" else 1)):
            ms, plain, lib = timed[key]
            flop_ms, byte_ms = bound_ms(*key)
            for k, v in zip(("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms", "bound_ms"),
                            (ms, plain, lib, flop_ms, byte_ms, max(flop_ms, byte_ms))):
                totals[k] += n * v
    for (C, F, vol), (ms, plain, lib) in timed.items():
        flop_ms, byte_ms = bound_ms(C, F, vol)
        tflops = 2 * BATCH * math.prod(vol) * 27 * C * F / ms / 1e9
        by = "operations" if flop_ms >= byte_ms else "bytes"
        print(f"[kernel] B=4 {C:>3}->{F:<3} @{vol}: {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
              f"bound {max(flop_ms, byte_ms):.3f} ms ({by}), plain {plain:.3f} ms, "
              f"F.conv3d {lib:.3f} ms")
    return max_abs, max_rel, totals


def reference_phase():
    """A tiny SparK in fp32: the card (kernel) against the CPU (plain)."""
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
    check(student.fmap == (7, 7, 8) and student.len_keep == 157 and len_loss == 58,
          f"main-path sizes {student.fmap} {student.len_keep} {len_loss}")
    n_params = sum(p.numel() for p in student.parameters())
    print(f"[slice] STUNet-B SparK, {n_params} parameters, patch {cfg.patch_size}, "
          f"batch {BATCH}, bf16; fmap {student.fmap}, keep {student.len_keep}, "
          f"forced {len_loss}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    conv3d_3x3.launches = 0  # counts from here on belong to the main path
    for step in range(STEPS):
        before = conv3d_3x3.launches
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
        check(conv3d_3x3.launches - before == 50,
              f"step {step}: {conv3d_3x3.launches - before} kernel launches, expected 50")
        moved = False
        for e, o, p in zip(teacher.parameters(), old, student.parameters()):
            want = o + 0.001 * (p.detach() - o)
            check((e - want).abs().max().item() <= 1e-6, f"step {step}: EMA law broken")
            moved = moved or not torch.equal(e, o)
        check(moved, f"step {step}: the teacher did not move")
        print(f"[slice] step {step}: loss {losses[-1]:.6f}, {times[-1]:.1f} ms, "
              f"launches {conv3d_3x3.launches - before}")
    launches = conv3d_3x3.launches
    step_ms = statistics.median(times[WARMUP:])
    peak = torch.cuda.max_memory_allocated()
    print(f"[slice] step {step_ms:.1f} ms (median of {STEPS - WARMUP}), "
          f"{BATCH / step_ms * 1e3:.3f} patches/s, peak memory {peak / 2**30:.2f} GiB, "
          f"{launches} kernel launches in {STEPS} steps")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 1
    smi = gpu_line()
    print(f"[device] {smi} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"| CUDA {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.load("conv3x3")
    build_s = time.perf_counter() - t0
    log = _build.library_path("conv3x3").with_suffix(".log").read_text()
    print(f"[build] csrc/conv3x3.cu for sm_90a in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs, max_rel, totals = kernel_phase(gen)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reference_phase()
    torch.cuda.empty_cache()
    launches = slice_phase()

    kernel = dict(
        name="conv3d_3x3", route="cuda", source="anatomask_torch/csrc/conv3x3.cu",
        replaces="anatomask_tpu/ops/pallas_conv.py:108", launches=launches,
        max_abs_err=max_abs, max_rel_err=max_rel, checked=True,
        ms=totals["ms"], plain_ms=totals["plain_ms"], bound_ms=totals["bound_ms"],
        bound_by="operations" if totals["flop_ms"] >= totals["byte_ms"] else "bytes",
        library_ms=totals["library_ms"],
        per="the 50 launches of one step at B = 4 (sums over call sites)")
    print(smi)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The work of the STUNet family's cells, counted from the configuration's
shapes: every convolution of a forward (for the model's FLOPs) and the
stride-1 3x3x3 ones with their launches (for the roofline of the port's
kernels #1 and #2).

Model FLOPs count the dense convolutions, 1x1 and transposed included (a
k = 4, stride 2 transposed conv feeds each output voxel from 8 taps), at 2
FLOP a multiply-add: a pretraining step is the batch times the teacher's
forward, the student's forward and its backward (twice the forward), with no
recompute under activation checkpointing; a predicted case is its tiles
times the mirrored copies of one forward. The finest densify layer, whose
output no decoder block reads, is not computed and not counted.

A stride-1 3x3x3 conv's bound (PERF.md's rule) is the larger of its FLOPs
over the peak rate and the bytes it must move over the memory's: its input
and weight read once and its output written once. Its input gradient, the
same conv of the output gradient with the flipped weight, has the same
bound. Each forward and each input gradient is one launch of kernel #1 or
#2, whichever the port picks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence


@dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    taps: int           # multiply-adds an output element takes per input channel
    out_shape: tuple    # spatial extents of the output
    in_shape: tuple     # spatial extents of the input
    stride1_3x3: bool   # a stride-1 3x3x3 conv: kernels #1 and #2 run it
    remat: bool         # under activation checkpointing (a third forward)
    first: bool         # the network's first conv: no input gradient

    def flops(self, batch: int = 1) -> float:
        return 2.0 * batch * math.prod(self.out_shape) * self.taps * self.cin * self.cout


def _down(shape, d):
    return tuple(s >> d for s in shape)


def _encoder(cin, widths, blocks, patch, remat) -> List[Conv]:
    out = []
    for d, (c, n) in enumerate(zip(widths, blocks)):
        res, prev = _down(patch, d), _down(patch, max(d - 1, 0))
        for b in range(n):
            ci = cin if b == 0 else c
            src = prev if b == 0 else res
            name = f"enc{d}.{b}"
            out.append(Conv(f"{name}.conv1", ci, c, 27, res, src, d == 0 or b > 0, remat,
                            d == 0 and b == 0))
            out.append(Conv(f"{name}.conv2", c, c, 27, res, res, True, remat, False))
            if b == 0:
                out.append(Conv(f"{name}.conv3", ci, c, 1, res, src, False, remat, False))
        cin = c
    return out


def spark_convs(cfg: dict) -> List[Conv]:
    """The convs of one SparK forward of one sample."""
    p = cfg["pretrain"]
    n, patch, remat = p["encoder_stages"], tuple(p["patch_size"]), p["remat"]
    widths = cfg["stage_widths"][:n]
    out = _encoder(cfg["in_channels"], widths, cfg["blocks_per_stage"][:n], patch, remat)
    width = p["decoder_width"]
    for i in range(n - 1):
        e, d, res = widths[-1 - i], width >> i, _down(patch, n - 1 - i)
        if not (i == 0 and e == d):
            k = 1 if i == 0 else 3
            out.append(Conv(f"densify{i}", e, d, k ** 3, res, res, k == 3, False, False))
        up = _down(patch, n - 2 - i)
        out.append(Conv(f"dec{i}.up", d, d, 8, up, res, False, remat, False))
        out.append(Conv(f"dec{i}.conv0", d, d, 27, up, up, True, remat, False))
        out.append(Conv(f"dec{i}.conv1", d, d // 2, 27, up, up, True, remat, False))
    out.append(Conv("proj", width >> (n - 1), cfg["in_channels"], 1, patch, patch, False, False,
                    False))
    return out


def segnet_convs(cfg: dict) -> List[Conv]:
    """The convs of one segmentation-STUNet forward of one sample at the
    configuration's `segmentation.patch_size`."""
    widths, blocks = cfg["stage_widths"], cfg["blocks_per_stage"]
    patch = tuple(cfg["segmentation"]["patch_size"])
    out = _encoder(cfg["in_channels"], widths, blocks, patch, False)
    n = len(widths) - 1
    for u in range(n):
        c_low, c, res = widths[-1 - u], widths[-2 - u], _down(patch, n - 1 - u)
        out.append(Conv(f"up{u}", c_low, c, 1, res, res, False, False, False))
        for b in range(blocks[-2 - u]):
            ci = 2 * c if b == 0 else c
            out.append(Conv(f"dec{u}.{b}.conv1", ci, c, 27, res, res, True, False, False))
            out.append(Conv(f"dec{u}.{b}.conv2", c, c, 27, res, res, True, False, False))
            if b == 0:
                out.append(Conv(f"dec{u}.{b}.conv3", ci, c, 1, res, res, False, False, False))
    out.append(Conv("seg", widths[0], cfg["num_classes"], 1, patch, patch, False, False, False))
    return out


def conv_bound_s(c: Conv, batch: int, peak_flops: float, peak_bytes: float,
                 itemsize: int) -> float:
    """The least seconds one launch of a stride-1 3x3x3 conv (or its input
    gradient) over `batch` samples can take."""
    nbytes = (batch * (math.prod(c.in_shape) * c.cin + math.prod(c.out_shape) * c.cout)
              + 27 * c.cin * c.cout) * itemsize
    return max(c.flops(batch) / peak_flops, nbytes / peak_bytes)


@dataclass(frozen=True)
class Work:
    """A unit of work (a step or a case): model FLOPs, the stride-1 3x3x3
    convs' launches on kernels #1 and #2 and their summed bound."""
    flops: float
    conv_launches: int
    conv_bound_s: float


def pretrain_step(cfg: dict, batch: int, peak_flops: float, peak_bytes: float,
                  itemsize: int) -> Work:
    """An AnatoMask step of `batch` samples in the configuration's
    `pretrain.grad_accum_steps` microbatches: per microbatch the teacher's
    forward, the student's (a second one under remat) and the student's
    input gradients (not of the first conv)."""
    convs = spark_convs(cfg)
    micro = cfg["pretrain"]["grad_accum_steps"]
    mb = batch // micro
    flops = batch * 4 * sum(c.flops() for c in convs)
    launches, bound = 0, 0.0
    for c in convs:
        if not c.stride1_3x3:
            continue
        n = 2 + c.remat + (not c.first)
        launches += micro * n
        bound += micro * n * conv_bound_s(c, mb, peak_flops, peak_bytes, itemsize)
    return Work(flops, launches, bound)


def predict_case(cfg: dict, tiles: int, flips: int, tile_batch: int, peak_flops: float,
                 peak_bytes: float, itemsize: int) -> Work:
    """A case of `tiles` tiles, each forwarded with its `flips` mirrored
    copies stacked on the batch, `tile_batch` tiles a forward."""
    convs = segnet_convs(cfg)
    batch = flips * tile_batch
    forwards = math.ceil(tiles / tile_batch)
    flops = tiles * flips * sum(c.flops() for c in convs)
    sites = [c for c in convs if c.stride1_3x3]
    bound = forwards * sum(conv_bound_s(c, batch, peak_flops, peak_bytes, itemsize)
                           for c in sites)
    return Work(flops, forwards * len(sites), bound)


def tile_count(shape: Sequence[int], tile: Sequence[int], step: float) -> int:
    """nnU-Net's tiles over a volume at least the tile in every axis."""
    return math.prod(int(math.ceil((s - t) / (t * step))) + 1 for s, t in zip(shape, tile))

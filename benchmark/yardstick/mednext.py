"""The work of the MedNeXt cells, counted from the configuration's shapes:
every conv of a forward for the model's FLOPs (the encoder's 1x1 stem,
depthwise k^3 convs and 1x1 expansions, contractions and residuals; the
densify layers, the LightDecoder and the projection as `yardstick/stunet.py`
counts them), the decoder's stride-1 3x3x3 convs with their launches of
kernels #1 and #2, and the depthwise convs' bound.

Model FLOPs follow `yardstick/stunet.py`: 2 FLOP a multiply-add, a step the
batch times the teacher's forward, the student's forward and its backward
(twice the forward). A depthwise conv of C channels takes k^3
multiply-adds an output element of each channel.

A depthwise conv's bound (PERF.md's rule for the convs) is the larger of its
FLOPs over the bf16 peak and its bytes over the memory's: its input read
once and its output written once, with the weight (the weight gradient
reads x and dy once and writes the weight: the same bytes). A step runs
each depthwise conv four times (the teacher's forward, the student's, the
input gradient and the weight gradient; a fifth, the recomputed forward,
under remat), whatever kernel runs them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from benchmark.yardstick import stunet
from benchmark.yardstick.stunet import Conv, conv_bound_s


@dataclass(frozen=True)
class Depthwise:
    name: str
    channels: int
    taps: int
    out_shape: tuple
    in_shape: tuple

    def flops(self, batch: int = 1) -> float:
        return 2.0 * batch * math.prod(self.out_shape) * self.taps * self.channels

    def nbytes(self, batch: int, itemsize: int) -> float:
        return (batch * self.channels * (math.prod(self.in_shape) + math.prod(self.out_shape))
                + self.taps * self.channels) * itemsize

    def bound_s(self, batch: int, peak_flops: float, peak_bytes: float, itemsize: int) -> float:
        """The least seconds one launch (forward, input or weight gradient)
        over `batch` samples can take."""
        return max(self.flops(batch) / peak_flops, self.nbytes(batch, itemsize) / peak_bytes)


@dataclass(frozen=True)
class Work(stunet.Work):
    """`yardstick/stunet.py`'s Work of a step, with the depthwise convs'
    launches and their summed bound."""
    depthwise_launches: int
    depthwise_bound_s: float


def encoder_convs(cfg: dict):
    """(dense convs, depthwise convs) of one encoder forward of one sample."""
    p = cfg["pretrain"]
    patch, remat = tuple(p["patch_size"]), p["remat"]
    w, n, e, k3 = cfg["stage_widths"], cfg["blocks_per_stage"], cfg["exp_r"], cfg["kernel_size"] ** 3
    dense = [Conv("stem", cfg["in_channels"], w[0], 1, patch, patch, False, remat, True)]
    dw: List[Depthwise] = []

    def block(name, cin, cout, src, res):
        dw.append(Depthwise(f"{name}.conv1", cin, k3, res, src))
        dense.append(Conv(f"{name}.conv2", cin, e * cin, 1, res, res, False, remat, False))
        dense.append(Conv(f"{name}.conv3", e * cin, cout, 1, res, res, False, remat, False))
        if cin != cout or src != res:
            dense.append(Conv(f"{name}.res_conv", cin, cout, 1, res, src, False, remat, False))

    for s in range(5):
        res = stunet._down(patch, s)
        for b in range(n[s]):
            block(f"{'bottleneck' if s == 4 else f'enc_block_{s}'}.{b}", w[s], w[s], res, res)
        if s < 4:
            block(f"down_{s}", w[s], w[s + 1], res, stunet._down(patch, s + 1))
    return dense, dw


def decoder_convs(cfg: dict) -> List[Conv]:
    """The densify layers, the LightDecoder and the projection of one
    forward of one sample (`yardstick/stunet.py`'s, which depend on the
    widths alone)."""
    return [c for c in stunet.spark_convs(cfg) if not c.name.startswith("enc")]


def pretrain_step(cfg: dict, batch: int, peak_flops: float, peak_bytes: float,
                  itemsize: int) -> Work:
    """An AnatoMask step of `batch` samples in `pretrain.grad_accum_steps`
    microbatches: per microbatch the teacher's forward, the student's (a
    second one under remat) and its backward."""
    dense, dw = encoder_convs(cfg)
    dec = decoder_convs(cfg)
    micro = cfg["pretrain"]["grad_accum_steps"]
    remat = cfg["pretrain"]["remat"]
    mb = batch // micro
    flops = batch * 4 * (sum(c.flops() for c in dense + dec) + sum(d.flops() for d in dw))
    launches, bound = 0, 0.0
    for c in dec:
        if c.stride1_3x3:
            n = 2 + c.remat + (not c.first)
            launches += micro * n
            bound += micro * n * conv_bound_s(c, mb, peak_flops, peak_bytes, itemsize)
    n_dw = 4 + remat
    dw_bound = micro * n_dw * sum(d.bound_s(mb, peak_flops, peak_bytes, itemsize) for d in dw)
    return Work(flops, launches, bound, micro * n_dw * len(dw), dw_bound)

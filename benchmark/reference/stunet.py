"""Plain PyTorch reference of the STUNet family as the benchmark's cells run
it: the AnatoMask SparK pretraining step (STUNet encoder under a patch mask,
SparK's densify layers, the LightDecoder, the per-patch normalised L2 loss,
the teacher-guided hard mask, AdamW as optax chains it after a global-norm
clip, the EMA teacher) and nnU-Net's Gaussian sliding-window prediction of
the segmentation STUNet with mirror test-time augmentation.

Written from the published descriptions (STU-Net, arXiv:2304.06716; SparK,
arXiv:2301.03580; AnatoMask, arXiv:2407.06468; nnU-Net's predictor), NCDHW,
float32, `F.conv3d` with TF32 off, no kernels, no activation checkpointing.
It imports nothing of the measured program. Parameters live in a dict keyed
by the state-dict names that the original torch code gives them, so that the
benchmark can load one set of weights into both sides.

`Quant` is the arithmetic of every convolution: `EXACT` leaves the operands
in float32; `FP8` rounds each conv's activation and weight to float8 e4m3 and
its output gradient to e5m2, with one scale a tensor, and is the control that
has to come out not correct.

Departures from the originals: the weights are drawn by the benchmark (laws
in `spark_params`/`segnet_params`: He normal, normal(0, 0.02) clipped at two
sigma, ones, zeros); the guided mask's random draws come in as arguments.
"""
from __future__ import annotations

import itertools
import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import gaussian_filter

Params = Dict[str, torch.Tensor]


# --- arithmetic of the convolutions ------------------------------------------

class Quant:
    """Identity rounding: float32 operands."""

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return w

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to `dtype` (a float8) under one scale that maps |x|'s max to
    the format's largest finite value; returned in x's dtype."""
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """Forward: round to e4m3. Backward: the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradFp8(torch.autograd.Function):
    """Forward: unchanged. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Fp8(Quant):
    def act(self, x):
        return _RoundFp8.apply(x)

    def weight(self, w):
        return _RoundFp8.apply(w)

    def out(self, y):
        return _RoundGradFp8.apply(y)


EXACT, FP8 = Quant(), Fp8()


@contextmanager
def float32_exact():
    """TF32 off for cuDNN and cuBLAS while the reference runs; the flags as
    they were afterwards."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def conv(q: Quant, x, w, b=None, stride=1, padding=None):
    pad = tuple(k // 2 for k in w.shape[2:]) if padding is None else padding
    return q.out(F.conv3d(q.act(x), q.weight(w), b, stride, pad))


def conv_transpose(q: Quant, x, w, b, stride=2, padding=1):
    return q.out(F.conv_transpose3d(q.act(x), q.weight(w), b, stride, padding))


def leaky(x):
    return F.leaky_relu(x, 0.01)


def instance_norm(x, w, b, eps=1e-5, m=None):
    """Per (sample, channel) over the voxels where m is 1 (all without m);
    zero where m is 0."""
    if m is None:
        m = torch.ones_like(x[:, :1])
    cnt = m.sum((2, 3, 4), keepdim=True).clamp_min(1.0)
    mean = (x * m).sum((2, 3, 4), keepdim=True) / cnt
    var = ((x - mean).square() * m).sum((2, 3, 4), keepdim=True) / cnt
    y = (x - mean) * torch.rsqrt(var + eps) * w.view(1, -1, 1, 1, 1) + b.view(1, -1, 1, 1, 1)
    return y * m


def upsample_mask(active: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """(B, 1, f1, f2, f3) bool -> float (B, 1, *shape), each patch repeated."""
    m = active
    for ax, n in enumerate(shape):
        m = m.repeat_interleave(int(n) // m.shape[ax + 2], dim=ax + 2)
    return m.float()


# --- parameter tables --------------------------------------------------------

def _conv(name, cin, cout, k, law="he", bias=True):
    out = [(f"{name}.weight", (cout, cin, k, k, k), law)]
    return out + [(f"{name}.bias", (cout,), "zeros")] if bias else out


def _norm(name, c):
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros")]


def _res_block(name, cin, cout, skip):
    out = _conv(f"{name}.conv1", cin, cout, 3) + _norm(f"{name}.norm1", cout)
    out += _conv(f"{name}.conv2", cout, cout, 3) + _norm(f"{name}.norm2", cout)
    return out + (_conv(f"{name}.conv3", cin, cout, 1) if skip else [])


def _encoder(prefix, cin, widths, blocks):
    out = []
    for d, (c, n) in enumerate(zip(widths, blocks)):
        for b in range(n):
            out += _res_block(f"{prefix}conv_blocks_context.{d}.{b}", cin if b == 0 else c, c,
                              skip=b == 0)
        cin = c
    return out


def spark_params(cfg: dict) -> list:
    """(name, shape, init law) of every parameter of the SparK model of a
    configuration: the masked STUNet encoder (`pretrain.encoder_stages`
    stages), the densify norms, mask tokens and projections, and the
    LightDecoder of width `pretrain.decoder_width`."""
    p = cfg["pretrain"]
    widths = cfg["stage_widths"][:p["encoder_stages"]]
    blocks = cfg["blocks_per_stage"][:p["encoder_stages"]]
    out = _encoder("sparse_encoder.sp_cnn.", cfg["in_channels"], widths, blocks)
    width = p["decoder_width"]
    for i in range(len(widths) - 1):
        c = width >> i
        out += [(f"dense_decoder.dec.{i}.up_sample.weight", (c, c, 4, 4, 4), "trunc"),
                (f"dense_decoder.dec.{i}.up_sample.bias", (c,), "zeros")]
        out += _conv(f"dense_decoder.dec.{i}.conv.0", c, c, 3, "trunc", bias=False)
        out += _norm(f"dense_decoder.dec.{i}.conv.1", c)
        out += _conv(f"dense_decoder.dec.{i}.conv.3", c, c // 2, 3, "trunc", bias=False)
        out += _norm(f"dense_decoder.dec.{i}.conv.4", c // 2)
    out += _conv("dense_decoder.proj", width >> (len(widths) - 1), cfg["in_channels"], 1, "trunc")
    for i, e in enumerate(widths[::-1]):
        out += _norm(f"densify_norms.{i}", e)
    for i, e in enumerate(widths[::-1]):
        d = width >> i
        if not (i == 0 and e == d):
            out += _conv(f"densify_projs.{i}", e, d, 1 if i == 0 else 3)
    out += [(f"mask_tokens.{i}", (1, e, 1, 1, 1), "trunc") for i, e in enumerate(widths[::-1])]
    return out


def segnet_params(cfg: dict) -> list:
    """(name, shape, init law) of every parameter of the segmentation STUNet
    (all `stage_widths` stages, a 1x1 upsampling conv, a decoder stage and a
    1x1 head per level)."""
    widths, blocks = cfg["stage_widths"], cfg["blocks_per_stage"]
    out = _encoder("", cfg["in_channels"], widths, blocks)
    n = len(widths) - 1
    for u in range(n):
        c_low, c = widths[-1 - u], widths[-2 - u]
        out += _conv(f"upsample_layers.{u}.conv", c_low, c, 1)
        for b in range(blocks[-2 - u]):
            out += _res_block(f"conv_blocks_localization.{u}.{b}", 2 * c if b == 0 else c, c,
                              skip=b == 0)
    for u in range(n):
        out += _conv(f"seg_outputs.{u}", widths[-2 - u], cfg["num_classes"], 1)
    return out


# --- the SparK model ---------------------------------------------------------

def _block(P, name, x, stride, m, q, skip):
    y = conv(q, x, P[f"{name}.conv1.weight"], P[f"{name}.conv1.bias"], stride)
    y = leaky(instance_norm(y, P[f"{name}.norm1.weight"], P[f"{name}.norm1.bias"], 1e-5, m))
    y = conv(q, y, P[f"{name}.conv2.weight"], P[f"{name}.conv2.bias"])
    y = instance_norm(y, P[f"{name}.norm2.weight"], P[f"{name}.norm2.bias"], 1e-5, m)
    if skip:
        x = conv(q, x, P[f"{name}.conv3.weight"], P[f"{name}.conv3.bias"], stride)
        if m is not None:
            x = x * m
    return leaky(y + x)


def _encode(P, prefix, x, blocks, active, q):
    """Every stage's output, finest first; under `active` the masked law."""
    feats = []
    for d, n in enumerate(blocks):
        for b in range(n):
            stride = 2 if d > 0 and b == 0 else 1
            shape = [(s - 1) // stride + 1 for s in x.shape[2:]]
            m = None if active is None else upsample_mask(active, shape)
            x = _block(P, f"{prefix}conv_blocks_context.{d}.{b}", x, stride, m, q, b == 0)
        feats.append(x)
    return feats


def patchify(x: torch.Tensor, fmap: Sequence[int]) -> torch.Tensor:
    """(B, C, X, Y, Z) -> (B, f1 f2 f3, p1 p2 p3 C), patches in row-major
    order of the patch grid."""
    B, C = x.shape[:2]
    p = [s // f for s, f in zip(x.shape[2:], fmap)]
    x = x.reshape(B, C, fmap[0], p[0], fmap[1], p[1], fmap[2], p[2])
    return x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(B, math.prod(fmap), -1)


def spark_forward(P: Params, cfg: dict, x: torch.Tensor, active: torch.Tensor,
                  q: Quant = EXACT):
    """SparK: the encoder on x with the masked patches zeroed, each feature
    but the finest densified (masked instance norm, eps 1e-6; mask tokens
    where masked; projection to the decoder's width), the LightDecoder with
    additive skips, the 1x1 projection. Returns (patchified x,
    patchified reconstruction)."""
    p = cfg["pretrain"]
    n = p["encoder_stages"]
    blocks = cfg["blocks_per_stage"][:n]
    feats = _encode(P, "sparse_encoder.sp_cnn.", x * upsample_mask(active, x.shape[2:]),
                    blocks, active, q)[::-1]
    rec = 0
    for i in range(n - 1):  # one skip per decoder block; the finest feature is unread
        f = feats[i]
        m = upsample_mask(active, f.shape[2:])
        f = instance_norm(f, P[f"densify_norms.{i}.weight"], P[f"densify_norms.{i}.bias"],
                          1e-6, m)
        f = torch.where(m.bool(), f, P[f"mask_tokens.{i}"])
        if f"densify_projs.{i}.weight" in P:
            f = conv(q, f, P[f"densify_projs.{i}.weight"], P[f"densify_projs.{i}.bias"])
        d = f"dense_decoder.dec.{i}"
        y = conv_transpose(q, rec + f, P[f"{d}.up_sample.weight"], P[f"{d}.up_sample.bias"])
        y = conv(q, y, P[f"{d}.conv.0.weight"])
        y = instance_norm(y, P[f"{d}.conv.1.weight"], P[f"{d}.conv.1.bias"]).clamp(0.0, 6.0)
        y = conv(q, y, P[f"{d}.conv.3.weight"])
        rec = instance_norm(y, P[f"{d}.conv.4.weight"], P[f"{d}.conv.4.bias"])
        active = active.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
    rec = conv(q, rec, P["dense_decoder.proj.weight"], P["dense_decoder.proj.bias"])
    fmap = [s >> (n - 1) for s in x.shape[2:]]
    return patchify(x, fmap), patchify(rec, fmap)


def spark_loss(inp: torch.Tensor, rec: torch.Tensor, active: torch.Tensor):
    """Per-patch normalised L2 over the masked patches: (scalar, (B, L) map)."""
    mean = inp.mean(-1, keepdim=True)
    var = inp.var(-1, keepdim=True, correction=0)
    l2 = (rec - (inp - mean) / torch.sqrt(var + 1e-6)).square().mean(2)
    masked = 1.0 - active.reshape(active.shape[0], -1).float()
    loss_map = l2 * masked
    return loss_map.sum() / masked.sum(), loss_map


def keep_lowest(noise: torch.Tensor, len_keep: int, fmap: Sequence[int]) -> torch.Tensor:
    """The len_keep patches of lowest noise (ties by index) visible:
    (B, 1, *fmap) bool."""
    keep = torch.zeros_like(noise, dtype=torch.bool)
    keep.scatter_(1, torch.argsort(noise, dim=1, stable=True)[:, :len_keep], True)
    return keep.reshape(noise.shape[0], 1, *fmap)


def forced_patches(loss_map: torch.Tensor, len_loss: int) -> torch.Tensor:
    """(B, L) bool: the len_loss patches of highest loss (ties by index)."""
    out = torch.zeros_like(loss_map, dtype=torch.bool)
    out.scatter_(1, torch.argsort(-loss_map, dim=1, stable=True)[:, :len_loss], True)
    return out


def guided_mask(forced: torch.Tensor, noise: torch.Tensor, len_keep: int,
                fmap: Sequence[int]) -> torch.Tensor:
    """AnatoMask's hard mask: the forced patches always masked, the visible
    ones the len_keep of lowest noise among the rest."""
    return keep_lowest(torch.where(forced, torch.inf, noise), len_keep, fmap)


# --- the AnatoMask step ------------------------------------------------------

def decays(names: Sequence[str], shapes: Sequence[Sequence[int]]) -> List[bool]:
    """Weight decay applies to every parameter of two or more dimensions but
    the mask tokens and the biases."""
    return ["mask_token" not in n and "bias" not in n and len(s) > 1
            for n, s in zip(names, shapes)]


class AdamW:
    """optax.adamw after optax.clip_by_global_norm: b1 0.9, b2 0.999, eps
    1e-8 outside the square root, bias-corrected moments, decoupled decay
    added to the update, -lr."""

    def __init__(self, params: Params, lr, weight_decay, clip, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        names = list(params)
        self.wd = dict(zip(names, (weight_decay if d else 0.0 for d in
                                   decays(names, [params[n].shape for n in names]))))
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> Params:
        """Clip and apply `grads`; returns the gradients as clipped."""
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        clipped = {}
        for n, p in params.items():
            g = grads[n] * scale
            clipped[n] = g
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + self.eps)
            p.sub_(self.lr * (u + self.wd[n] * p))
        return clipped


def anatomask_steps(P0: Params, cfg: dict, batches: Sequence[torch.Tensor],
                    noises: Sequence[torch.Tensor], len_loss: int, ema_decay: float,
                    hard_masks: Optional[Sequence[torch.Tensor]] = None, q: Quant = EXACT,
                    batch_fraction: float = 1.0) -> dict:
    """AnatoMask steps from the weights P0 (teacher = student = P0): for each
    batch x (B, C, X, Y, Z) and its uniforms noise (2, B, L), the teacher's
    reconstruction under the random mask of noise[0], its per-patch loss,
    the hard mask (from `hard_masks[k]` where given, else from the forced
    patches and noise[1]), the student's loss and gradient sample by sample,
    AdamW after the clip, the EMA. `batch_fraction` < 1 takes the student's
    loss over that leading share of the batch alone (a fault).

    Returns the record the benchmark compares: each step's loss, loss map
    and hard mask, the first step's clipped gradients, and the student's
    and the teacher's weights after the last step."""
    p = cfg["pretrain"]
    fmap = [s >> (p["encoder_stages"] - 1) for s in p["patch_size"]]
    L = math.prod(fmap)
    len_keep = round(L * (1 - p["mask_ratio"]))
    student = {n: t.detach().clone().float() for n, t in P0.items()}
    teacher = {n: t.clone() for n, t in student.items()}
    opt = AdamW(student, p["lr"], p["weight_decay"], p["grad_clip"])
    rec = {"loss": [], "loss_map": [], "hard": [], "grad": None}
    for k, (x, noise) in enumerate(zip(batches, noises)):
        B = x.shape[0]
        n_used = max(1, int(B * batch_fraction))
        grads = {n: torch.zeros_like(t) for n, t in student.items()}
        losses, maps, hards = [], [], []
        for i in range(B):
            xi = x[i:i + 1].float()
            with torch.no_grad():
                mask1 = keep_lowest(noise[0, i:i + 1], len_keep, fmap)
                _, lm = spark_loss(*spark_forward(teacher, cfg, xi, mask1, q), mask1)
                if hard_masks is None:
                    hard = guided_mask(forced_patches(lm, len_loss), noise[1, i:i + 1],
                                       len_keep, fmap)
                else:
                    hard = hard_masks[k][i:i + 1].reshape(1, 1, *fmap)
            maps.append(lm)
            hards.append(hard)
            with torch.set_grad_enabled(i < n_used):
                leaves = {n: t.requires_grad_(i < n_used) for n, t in student.items()}
                loss = spark_loss(*spark_forward(leaves, cfg, xi, hard, q), hard)[0]
            if i < n_used:
                g = torch.autograd.grad(loss / n_used, list(leaves.values()), allow_unused=True)
                for (n, acc), gi in zip(grads.items(), g):
                    if gi is not None:
                        acc.add_(gi)
            losses.append(loss.detach())
            for t in student.values():
                t.requires_grad_(False)
        clipped = opt.step(student, grads)
        if k == 0:
            rec["grad"] = clipped
        with torch.no_grad():
            for n, t in teacher.items():
                t.lerp_(student[n], 1.0 - ema_decay)
        rec["loss"].append(torch.stack(losses[:n_used]).mean())
        rec["loss_map"].append(torch.cat(maps))
        rec["hard"].append(torch.cat(hards).reshape(B, L))
    rec["student"], rec["teacher"] = student, teacher
    return rec


# --- the segmentation STUNet and the sliding window --------------------------

def segnet_forward(P: Params, cfg: dict, x: torch.Tensor, q: Quant = EXACT) -> torch.Tensor:
    """The full-resolution logits of the segmentation STUNet (no deep
    supervision): encoder; per level a nearest upsampling by 2, a 1x1 conv,
    the concatenation [upsampled, skip], a decoder stage; the last 1x1 head."""
    blocks = cfg["blocks_per_stage"]
    skips = _encode(P, "", x, blocks, None, q)
    x = skips.pop()
    for u in range(len(blocks) - 1):
        up = x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
        up = conv(q, up, P[f"upsample_layers.{u}.conv.weight"], P[f"upsample_layers.{u}.conv.bias"])
        x = torch.cat([up, skips.pop()], 1)
        for b in range(blocks[-2 - u]):
            x = _block(P, f"conv_blocks_localization.{u}.{b}", x, 1, None, q, b == 0)
    u = len(blocks) - 2
    return conv(q, x, P[f"seg_outputs.{u}.weight"], P[f"seg_outputs.{u}.bias"])


def gaussian_map(tile: Sequence[int], scale: float = 1000.0) -> np.ndarray:
    """nnU-Net's importance map: a centred impulse blurred with sigma =
    tile / 8, scaled to `scale` at its peak, zeros set to the least nonzero."""
    g = np.zeros(tile)
    g[tuple(t // 2 for t in tile)] = 1
    g = gaussian_filter(g, [t / 8 for t in tile], 0, mode="constant", cval=0)
    g = (g / g.max() * scale).astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


def tile_origins(shape: Sequence[int], tile: Sequence[int], step: float) -> List[tuple]:
    """nnU-Net's tile placement: evenly spaced origins from 0 to shape - tile,
    at most tile * step apart."""
    axes = []
    for s, t in zip(shape, tile):
        n = int(np.ceil((s - t) / (t * step))) + 1
        gap = (s - t) / (n - 1) if n > 1 else 0
        axes.append([int(np.round(gap * i)) for i in range(n)])
    return list(itertools.product(*axes))


@torch.no_grad()
def sliding_window_logits(P: Params, cfg: dict, volume: torch.Tensor, tile: Sequence[int],
                          step: float, mirror_axes: Sequence[int], q: Quant = EXACT
                          ) -> torch.Tensor:
    """(C, X, Y, Z) volume, each axis at least the tile -> (K, X, Y, Z)
    logits: every tile predicted under each mirroring of `mirror_axes` and
    averaged, Gaussian-weighted, summed over tiles and normalised."""
    K = cfg["num_classes"]
    g = torch.from_numpy(gaussian_map(tuple(tile))).to(volume.device)
    logits = torch.zeros((K, *volume.shape[1:]), device=volume.device)
    weight = torch.zeros(volume.shape[1:], device=volume.device)
    flips = [tuple(a + 2 for a in c) for r in range(len(mirror_axes) + 1)
             for c in itertools.combinations(mirror_axes, r)]
    for o in tile_origins(volume.shape[1:], tile, step):
        sl = tuple(slice(a, a + t) for a, t in zip(o, tile))
        x = volume[(slice(None), *sl)][None].float()
        pred = 0
        for f in flips:
            y = segnet_forward(P, cfg, x.flip(f) if f else x, q)
            pred = pred + (y.flip(f) if f else y)
        logits[(slice(None), *sl)] += pred[0] / len(flips) * g
        weight[sl] += g
    return logits / weight

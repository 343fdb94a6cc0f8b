"""DA5's extra transforms (nnU-Net's nnUNetTrainerDA5), on the batch's device.
Counterpart of anatomask_tpu/data/augment_da5.py: Rot90 and TransposeAxes on
the axes of equal extent, OneOf(median filter | Gaussian blur), additive
brightness, OneOf(contrast preserving | stretching the range), a Gaussian-bump
brightness gradient, local gamma, blank rectangles (filled with the box's
mean) and sharpening, in JAX's order (`apply_da5_extras`).

As in `data/augment.py`, the draws are split from the work: `draw_da5` makes
every parameter on the host from a CPU `torch.Generator` (a dict of host
tensors and numbers), and each transform takes them, so that a test can hand
both packages the same draws. Where JAX computes a transform for the whole
batch and selects per sample or channel with `where`, the port computes it
only where the gate is set (the same values). The JAX package's deviations
from the reference stay: the median is an exact 27-tap (3^3) median applied
1-3 times, and sharpening is the unsharp mask x + s (x - box3(x)).
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as fn

from anatomask_torch.data.augment import IntensityAugmentConfig, gaussian_blur


@dataclass(frozen=True)
class DA5Config:
    p_rot90: float = 0.5
    p_transpose: float = 0.5
    p_median_or_blur: float = 0.2       # OneOf(median, blur), each gated at 0.2
    p_additive_brightness: float = 0.1
    additive_brightness_sigma: float = 0.5
    p_contrast: float = 0.2
    contrast_range: Tuple[float, float] = (0.5, 2.0)
    p_blank_rectangles: float = 0.4
    max_rectangles: int = 5
    p_brightness_gradient: float = 0.3
    p_local_gamma: float = 0.3
    p_sharpening: float = 0.2
    p_per_channel: float = 0.5


def _matching_axes(patch_size: Sequence[int]):
    """Spatial axes sharing the most-common extent (reference valid_axes)."""
    counts = [sum(p == q for q in patch_size) for p in patch_size]
    m = max(counts)
    return [i for i, c in enumerate(counts) if c == m], m


def rot90_pairs(patch_size: Sequence[int]) -> List[Tuple[int, int]]:
    """The planes of equal-extent axes that Rot90 may turn in."""
    valid, m = _matching_axes(patch_size)
    if m < 2:
        return []
    return [(a, b) for i, a in enumerate(valid) for b in valid[i + 1:]
            if patch_size[a] == patch_size[b]]


def transpose_perms(patch_size: Sequence[int]):
    """(the equal-extent axes, their permutations but the identity)."""
    valid, m = _matching_axes(patch_size)
    if m < 2:
        return valid, []
    valid = [a for a in valid if patch_size[a] == patch_size[valid[0]]]
    return valid, [p for p in permutations(valid) if p != tuple(valid)]


# --- random draws (host) ------------------------------------------------------

def _uniform(gen, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _bernoulli(gen, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen) < float(p)


def _randint(gen, lo: int, hi: int, shape=()) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen)


def _gate(gen, p: float, cfg: DA5Config, bc) -> torch.Tensor:
    """(B, C): the sample's draw at p and the channel's at p_per_channel."""
    return _bernoulli(gen, p, (bc[0], 1)) & _bernoulli(gen, cfg.p_per_channel, bc)


def _bump_params(gen, patch_size, bc):
    """A Gaussian bump's centre (B, 3, C), U(-0.5, 1.5) x size, and per-axis
    sigma (B, 3, C), exp(U(log(max(size / 6, 1)), log(size)))."""
    sizes = torch.tensor(patch_size, dtype=torch.float32)
    loc = _uniform(gen, (bc[0], 3, bc[1]), -0.5, 1.5) * sizes[None, :, None]
    log_lo = torch.log(torch.clamp(sizes / 6.0, min=1.0))
    log_hi = torch.log(sizes)
    sig = torch.exp(torch.rand((bc[0], 3, bc[1]), generator=gen)
                    * (log_hi - log_lo)[None, :, None] + log_lo[None, :, None])
    return loc, sig


def draw_da5(gen: torch.Generator, batch: int, channels: int, patch_size: Sequence[int],
             cfg: DA5Config, ic: IntensityAugmentConfig) -> Dict[str, object]:
    """Every draw of apply_da5_extras for a batch (B, *patch_size, C), as the
    JAX functions draw them: per-batch choices as Python numbers, per-sample
    and per-channel gates (B, C) bool, values (B, C) or (B, 3, C) fp32. The
    blur of the OneOf is the stack's gaussian_blur with the intensity config
    `ic`'s blur draws."""
    bc = (batch, channels)
    sizes = np.asarray(patch_size)
    d: Dict[str, object] = {}
    d["rot90_on"] = bool(_bernoulli(gen, cfg.p_rot90, ()))
    d["rot90_k"] = int(_randint(gen, 0, 4))
    d["rot90_pair"] = int(_randint(gen, 0, max(1, len(rot90_pairs(patch_size)))))
    d["transpose_on"] = bool(_bernoulli(gen, cfg.p_transpose, ()))
    d["transpose_perm"] = int(_randint(gen, 0, max(1, len(transpose_perms(patch_size)[1]))))
    d["median_pick"] = bool(_bernoulli(gen, 0.5, ()))
    d["median_on"] = _gate(gen, cfg.p_median_or_blur, cfg, bc)
    d["median_rounds"] = int(_randint(gen, 1, 4))
    d["blur_sigma"] = _uniform(gen, bc, *ic.blur_sigma)
    d["blur_on"] = (_bernoulli(gen, ic.p_blur, (batch, 1))
                    & _bernoulli(gen, ic.p_blur_per_channel, bc))
    d["brightness_on"] = _gate(gen, cfg.p_additive_brightness, cfg, bc)
    d["brightness_shift"] = torch.randn(bc, generator=gen) * cfg.additive_brightness_sigma
    d["contrast_preserve"] = bool(_bernoulli(gen, 0.5, ()))
    d["contrast_on"] = _gate(gen, cfg.p_contrast, cfg, bc)
    lo, hi = cfg.contrast_range
    d["contrast_factor"] = torch.where(_bernoulli(gen, 0.5, bc), _uniform(gen, bc, lo, 1.0),
                                       _uniform(gen, bc, 1.0, hi))
    d["gradient_on"] = _gate(gen, cfg.p_brightness_gradient, cfg, bc)
    d["gradient_loc"], d["gradient_sigma"] = _bump_params(gen, patch_size, bc)
    d["gradient_strength"] = _uniform(gen, bc, 1.0, 5.0) * torch.where(
        _bernoulli(gen, 0.5, bc), 1.0, -1.0)
    d["gamma_on"] = _gate(gen, cfg.p_local_gamma, cfg, bc)
    d["gamma_loc"], d["gamma_sigma"] = _bump_params(gen, patch_size, bc)
    d["gamma"] = torch.where(_bernoulli(gen, 0.5, bc), _uniform(gen, bc, 0.01, 0.8),
                             _uniform(gen, bc, 1.5, 4.0))
    d["rect_on"] = _gate(gen, cfg.p_blank_rectangles, cfg, bc)
    d["rect_count"] = _randint(gen, 1, cfg.max_rectangles + 1, (batch,))
    lo_w = np.maximum(1, sizes // 10)
    hi_w = np.maximum(lo_w + 1, sizes // 3)
    starts, widths = [], []
    for _ in range(cfg.max_rectangles):
        wid = torch.stack([_randint(gen, int(lo_w[a]), int(hi_w[a]), (batch,))
                           for a in range(3)], -1)
        start = torch.stack([_randint(gen, 0, max(1, int(sizes[a]) - int(lo_w[a])), (batch,))
                             for a in range(3)], -1)
        starts.append(torch.minimum(start, torch.from_numpy(sizes)[None] - wid))
        widths.append(wid)
    d["rect_start"], d["rect_width"] = torch.stack(starts), torch.stack(widths)
    d["sharpen_on"] = _gate(gen, cfg.p_sharpening, cfg, bc)
    d["sharpen_strength"] = _uniform(gen, bc, 0.1, 1.0)
    return d


# --- transforms (device) ------------------------------------------------------
# x (B, X, Y, Z, C) fp32 on its device, seg (B, X, Y, Z, S) or None; gates
# and values on the host. Each returns new tensors and leaves its inputs.

def rot90_transform(x: torch.Tensor, seg, on: bool, k: int, pair: int, patch_size):
    """The whole batch turned k x 90 degrees in the pair-th plane of
    rot90_pairs (numpy's rot90 direction)."""
    pairs = rot90_pairs(patch_size)
    if not pairs or not on or k == 0:
        return x, seg
    a, b = pairs[pair]

    def turn(v):
        return None if v is None else torch.rot90(v, k, (a + 1, b + 1))

    return turn(x), turn(seg)


def transpose_axes_transform(x: torch.Tensor, seg, on: bool, perm: int, patch_size):
    """The whole batch's equal-extent axes permuted by the perm-th
    permutation of transpose_perms: output axis dst takes input axis src."""
    valid, perms = transpose_perms(patch_size)
    if not perms or not on:
        return x, seg
    axes = list(range(x.ndim))
    for src, dst in zip(valid, perms[perm]):
        axes[dst + 1] = src + 1

    def move(v):
        return None if v is None else v.permute(axes)

    return move(x), move(seg)


def _shifted27(vol: torch.Tensor) -> List[torch.Tensor]:
    """The 27 edge-replicated 3x3x3 neighbours of each voxel of vol (X, Y, Z),
    in JAX's tap order (dz, dy, dx)."""
    X, Y, Z = vol.shape
    vp = fn.pad(vol[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    return [vp[dz:dz + X, dy:dy + Y, dx:dx + Z]
            for dz in range(3) for dy in range(3) for dx in range(3)]


def _median3(vol: torch.Tensor) -> torch.Tensor:
    """Exact 27-tap median (an odd count: torch's lower median is the
    median)."""
    return torch.stack(_shifted27(vol), -1).median(dim=-1).values


def _box_blur3(vol: torch.Tensor) -> torch.Tensor:
    acc = 0.0
    for tap in _shifted27(vol):
        acc = acc + tap
    return acc / 27.0


def _pairs(on: torch.Tensor):
    return torch.nonzero(on).tolist()


def median_or_blur(x: torch.Tensor, pick_median: bool, on: torch.Tensor, rounds: int,
                   blur_sigma: torch.Tensor, blur_on: torch.Tensor) -> torch.Tensor:
    """OneOf(median filter | Gaussian blur): the median (`rounds` passes of
    the 27-tap median) where `on`, or the stack's blur with its own gates."""
    if not pick_median:
        return gaussian_blur(x, blur_sigma, blur_on)
    out = x.clone()
    for b, c in _pairs(on):
        m = x[b, ..., c]
        for _ in range(rounds):
            m = _median3(m)
        out[b, ..., c] = m
    return out


def additive_brightness(x: torch.Tensor, on: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for b, c in _pairs(on):
        out[b, ..., c] = x[b, ..., c] + float(shift[b, c])
    return out


def contrast_oneof(x: torch.Tensor, preserve: bool, on: torch.Tensor,
                   factor: torch.Tensor) -> torch.Tensor:
    """(x - mean) * factor + mean per (sample, channel), clipped back to the
    channel's range when `preserve`."""
    out = x.clone()
    for b, c in _pairs(on):
        v = x[b, ..., c]
        mean = v.mean()
        y = (v - mean) * factor[b, c].to(x.device) + mean
        out[b, ..., c] = torch.clamp(y, v.min(), v.max()) if preserve else y
    return out


def _gauss_bump(shape, loc: torch.Tensor, sig: torch.Tensor, device) -> torch.Tensor:
    """One Gaussian bump (X, Y, Z): the product over the axes of
    exp(-0.5 ((i - loc) / sigma)^2); loc, sig (3,)."""
    bump = 1.0
    for a, n in enumerate(shape):
        g = torch.arange(n, dtype=torch.float32, device=device)
        e = torch.exp(-0.5 * torch.square((g - loc[a].to(device)) / sig[a].to(device)))
        bump = bump * e.reshape([n if i == a else 1 for i in range(3)])
    return bump


def brightness_gradient_additive(x: torch.Tensor, on: torch.Tensor, loc: torch.Tensor,
                                 sig: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """x + bump * strength (strength = +-U(1, 5))."""
    out = x.clone()
    for b, c in _pairs(on):
        bump = _gauss_bump(x.shape[1:4], loc[b, :, c], sig[b, :, c], x.device)
        out[b, ..., c] = x[b, ..., c] + bump * strength[b, c].to(x.device)
    return out


def local_gamma(x: torch.Tensor, on: torch.Tensor, loc: torch.Tensor, sig: torch.Tensor,
                gamma: torch.Tensor) -> torch.Tensor:
    """x blended with its gamma-mapped copy (over the channel's range), a
    clipped Gaussian bump the blend weight."""
    out = x.clone()
    for b, c in _pairs(on):
        v = x[b, ..., c]
        bump = torch.clamp(_gauss_bump(x.shape[1:4], loc[b, :, c], sig[b, :, c], x.device),
                           0.0, 1.0)
        mn = v.min()
        rng = torch.clamp(v.max() - mn, min=1e-8)
        xg = torch.pow(torch.clamp((v - mn) / rng, 1e-8, 1.0), gamma[b, c].to(x.device)) * rng + mn
        out[b, ..., c] = bump * xg + (1.0 - bump) * v
    return out


def blank_rectangles(x: torch.Tensor, on: torch.Tensor, count: torch.Tensor,
                     start: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
    """Boxes 0 .. count[b] - 1 (start, width (R, B, 3)) of each gated
    (sample, channel), in turn, filled with the box's mean at that point."""
    out = x.clone()
    for i in range(start.shape[0]):
        for b, c in _pairs(on):
            if i >= int(count[b]):
                continue
            s, w = start[i, b].tolist(), width[i, b].tolist()
            box = out[b, s[0]:s[0] + w[0], s[1]:s[1] + w[1], s[2]:s[2] + w[2], c]
            box.fill_(box.sum() / float(box.numel()))
    return out


def sharpening(x: torch.Tensor, on: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """x + s (x - box3(x)), box3 the edge-replicated 3x3x3 mean."""
    out = x.clone()
    for b, c in _pairs(on):
        v = x[b, ..., c]
        out[b, ..., c] = v + strength[b, c].to(x.device) * (v - _box_blur3(v))
    return out


def apply_da5_extras(draws: Dict[str, object], data: torch.Tensor, seg, patch_size):
    """The DA5-only transforms with the given draws, in the reference's
    order; data (B, *patch, C) fp32, seg (B, *patch, S) or None (turned and
    transposed with the data)."""
    d = draws
    data, seg = rot90_transform(data, seg, d["rot90_on"], d["rot90_k"], d["rot90_pair"],
                                patch_size)
    data, seg = transpose_axes_transform(data, seg, d["transpose_on"], d["transpose_perm"],
                                         patch_size)
    data = median_or_blur(data, d["median_pick"], d["median_on"], d["median_rounds"],
                          d["blur_sigma"], d["blur_on"])
    data = additive_brightness(data, d["brightness_on"], d["brightness_shift"])
    data = contrast_oneof(data, d["contrast_preserve"], d["contrast_on"], d["contrast_factor"])
    data = brightness_gradient_additive(data, d["gradient_on"], d["gradient_loc"],
                                        d["gradient_sigma"], d["gradient_strength"])
    data = local_gamma(data, d["gamma_on"], d["gamma_loc"], d["gamma_sigma"], d["gamma"])
    data = blank_rectangles(data, d["rect_on"], d["rect_count"], d["rect_start"],
                            d["rect_width"])
    data = sharpening(data, d["sharpen_on"], d["sharpen_strength"])
    return data, seg

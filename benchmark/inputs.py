"""What the benchmark makes from a run's seed and hands to both the program
and the reference: weights, input data, random draws. Everything is drawn
on the run's device from `torch.Generator`s seeded from the run's seed, in
a few large calls."""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

# purposes of the generators derived from a run's seed
WEIGHTS, DATA, NOISE, SAMPLE = 1, 2, 3, 4


def subseed(seed: int, purpose: int) -> int:
    """A 63-bit seed for one purpose of a run; any whole seed works."""
    return (int(seed) * 0x9E3779B97F4A7C15 + purpose * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(seed: int, purpose: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, purpose))


def make_weights(table: Sequence[Tuple[str, tuple, str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 weights for a table of (name, shape, law): "he" He normal over
    the fan-in (nnU-Net's InitWeights_He, negative slope 1e-2), "trunc"
    normal(0, 0.02) clipped at two sigma, "ones", "zeros". The random ones
    are views of one draw."""
    drawn = sum(math.prod(s) for _, s, law in table if law in ("he", "trunc"))
    buf = torch.randn(drawn, generator=generator(seed, WEIGHTS, device), device=device)
    out, at = {}, 0
    for name, shape, law in table:
        if law == "ones":
            out[name] = torch.ones(shape, device=device)
        elif law == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            w = buf[at:at + n].view(shape)
            at += n
            if law == "he":
                w.mul_(math.sqrt(2.0 / (1.0 + 1e-4) / math.prod(shape[1:])))
            elif law == "trunc":
                w.clamp_(-2.0, 2.0).mul_(0.02)
            else:
                raise ValueError(f"unknown init law {law!r} of {name}")
            out[name] = w
    return out


def normal_data(shape: Sequence[int], seed: int, device, purpose: int = DATA) -> torch.Tensor:
    """float32 standard normal data, the intensities of a z-scored scan."""
    return torch.randn(tuple(shape), generator=generator(seed, purpose, device), device=device)

"""AnatoMask teacher-guided mask generation. Counterpart of
anatomask_tpu/ssl/anatomask.py.

The len_loss patches with the highest teacher loss are always masked; the
other masked slots are uniform over the rest. Forced patches get +inf noise
and the keep set is the len_keep lowest-noise patches, the same law as the
reference's per-sample shuffle, with no host loop.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from anatomask_torch.ssl.spark import keep_lowest


def guided_keep_ratio(epoch, total_epoch: int, guide: bool = True) -> float:
    """Easy-to-hard curriculum; a static 2/3 when unguided."""
    if not guide:
        return 2.0 / 3.0
    return (epoch + 1.0) / total_epoch * 0.5


def generate_guided_mask(loss_pred: torch.Tensor, fmap: Sequence[int], len_keep: int,
                         len_loss: int, generator: Optional[torch.Generator] = None,
                         noise: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """loss_pred (B, L) teacher per-patch loss -> (hard, easy) masks
    (B, 1, f1, f2, f3) bool, True = keep. `noise` (B, L) uniforms replaces the
    draw from `generator`, so that a test can feed two frameworks the same."""
    B, L = loss_pred.shape
    order = torch.argsort(-loss_pred, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)  # 0 = hardest patch
    if noise is None:
        noise = torch.rand((B, L), generator=generator, device=loss_pred.device)
    inf = torch.tensor(float("inf"), device=noise.device, dtype=noise.dtype)
    hard = keep_lowest(torch.where(ranks < len_loss, inf, noise), fmap, len_keep)
    band = (ranks >= len_loss) & (ranks < 2 * len_loss)
    easy = keep_lowest(torch.where(band, inf, noise), fmap, len_keep + len_loss)
    return hard, easy

"""Segmentation losses. Counterpart of anatomask_tpu/training/losses.py
(nnU-Net's MemoryEfficientSoftDiceLoss, RobustCrossEntropyLoss, TopKLoss,
DC_and_CE_loss, DC_and_BCE_loss, DC_and_topk_loss, the deep-supervision
weighting, and the validation's hard Dice counts).

Conventions as the JAX package's: logits channels-last (B, *spatial, K), so
the network's NCDHW output in channels_last_3d memory enters by a free
permute; labels (B, *spatial) int, or regions one-hot (B, *spatial, K) with an
optional trailing ignore channel; loss masks (B, *spatial, 1). Softmax,
log-softmax and every reduction run in fp32 whatever the logits' dtype.

Under a process group (parallel/mesh.py) each rank holds its rows of the
global batch, and every statistic JAX's step takes over the global batch is
summed across the ranks, JAX's `_maybe_psum`: batch Dice's tp, fp and fn, the
valid-voxel counts of the masked CE and BCE means, and the top-k threshold.
A rank's loss is its share of the global loss (the mean over the ranks is
JAX's loss): the global Dice as it is, a mean as the world size times the
rank's sum over the global count. Without a group every reduction is the
rank's own.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as fn

from anatomask_torch.parallel import mesh


def soft_dice_parts(probs: torch.Tensor, target_onehot: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tp/fp/fn per (batch, class), reduced over the spatial dims."""
    probs = probs.float()
    target_onehot = target_onehot.float()
    if loss_mask is not None:
        m = loss_mask.float()
        probs = probs * m
        target_onehot = target_onehot * m
    axes = tuple(range(1, probs.ndim - 1))
    tp = (probs * target_onehot).sum(axes)
    fp = probs.sum(axes) - tp
    fn_ = target_onehot.sum(axes) - tp
    return tp, fp, fn_


def _one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    return fn.one_hot(target.long(), num_classes).float()


def memory_efficient_soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                                    batch_dice: bool = True, do_bg: bool = False,
                                    smooth: float = 1e-5, apply_nonlin: str = "softmax",
                                    loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """target: int labels (B, *spatial) for softmax, or one-hot (B, *spatial,
    K) for sigmoid regions."""
    num_classes = logits.shape[-1]
    if apply_nonlin == "softmax":
        probs = torch.softmax(logits.float(), dim=-1)
    elif apply_nonlin == "sigmoid":
        probs = torch.sigmoid(logits.float())
    else:
        probs = logits.float()
    onehot = target.float() if target.ndim == logits.ndim else _one_hot(target, num_classes)
    if not do_bg:
        probs, onehot = probs[..., 1:], onehot[..., 1:]
    tp, fp, fn_ = soft_dice_parts(probs, onehot, loss_mask)
    if batch_dice:
        tp, fp, fn_ = tp.sum(0), fp.sum(0), fn_.sum(0)
        if mesh.distributed():
            tp, fp, fn_ = mesh.all_reduce_sum(torch.stack([tp, fp, fn_])).unbind(0)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn_ + smooth).clamp_min(1e-8)
    return -dc.mean()


def _nll(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Voxelwise -log softmax at the (clipped) label, fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    t = target.long().clamp(0, logits.shape[-1] - 1)
    return -torch.gather(logp, -1, t[..., None])[..., 0]


def _voxel_mask(loss_mask: torch.Tensor, ndim: int) -> torch.Tensor:
    m = loss_mask.float()
    return m[..., 0] if m.ndim == ndim + 1 else m


def _masked_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """total / count (>= 1e-8), the count the global batch's: under a
    process group this rank's share, world * total / the summed count."""
    if mesh.distributed():
        return total * mesh.world() / mesh.all_reduce_sum(count).clamp_min(1e-8)
    return total / count.clamp_min(1e-8)


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over the voxels (the valid ones, under a mask)."""
    nll = _nll(logits, target)
    if loss_mask is None:
        return nll.mean()
    m = _voxel_mask(loss_mask, nll.ndim)
    return _masked_mean((nll * m).sum(), m.sum())


def topk_loss(logits: torch.Tensor, target: torch.Tensor, k_percent: float = 10.0,
              loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over the hardest k% of the voxels of the whole batch (under a
    process group, of the global batch: `_global_topk_share`)."""
    nll = _nll(logits, target)
    if loss_mask is not None:
        nll = nll * _voxel_mask(loss_mask, nll.ndim)
    flat = nll.reshape(-1)
    if mesh.distributed():
        return _global_topk_share(flat, k_percent)
    k = max(1, int(flat.shape[0] * k_percent / 100))
    return torch.topk(flat, k, sorted=False).values.mean()


def _global_topk_share(flat: torch.Tensor, k_percent: float) -> torch.Tensor:
    """This rank's share of the mean of the k largest values of the global
    batch (every rank's `flat`, one size on each; k of the global count):
    the rank's largest values (no gradient) are gathered, the k-th largest
    of them all is the threshold, and the rank sums its values above it. Ties
    at the threshold are taken in rank order, lowest rank first (the global
    batch's row order, which JAX's top_k prefers among equal values), and
    within a rank as torch.topk picks them."""
    w = mesh.world()
    k = max(1, int(flat.shape[0] * w * k_percent / 100))
    every = mesh.gather_ranks(torch.topk(flat.detach(), min(k, flat.shape[0])).values)
    threshold = torch.topk(every.reshape(-1), k).values[-1]
    above, ties = (every > threshold).sum(1), (every == threshold).sum(1)
    before = ties.cumsum(0) - ties  # ties held by the lower ranks
    take = above + (k - above.sum() - before).clamp_min(0).minimum(ties)
    n = int(take[mesh.rank()])
    if n == 0:
        return flat.sum() * 0.0
    return torch.topk(flat, n, sorted=False).values.mean() * (n * w / k)


def bce_loss(logits: torch.Tensor, target: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sigmoid BCE for regions; under a mask the mean is over valid voxels
    (the mask broadcasts over the K region channels)."""
    x = logits.float()
    t = target.float()
    per = x.clamp_min(0) - x * t + torch.log1p(torch.exp(-x.abs()))
    if loss_mask is None:
        return per.mean()
    m = loss_mask.float()
    return _masked_mean((per * m).sum(), m.sum())


# --- compound losses ----------------------------------------------------------

def _split_ignore(target: torch.Tensor, ignore_label: Optional[int]):
    if ignore_label is None:
        return target, None
    ignored = target == ignore_label
    return torch.where(ignored, torch.zeros_like(target), target), (~ignored)[..., None]


def dc_and_ce_loss(logits: torch.Tensor, target: torch.Tensor, weight_ce: float = 1.0,
                   weight_dice: float = 1.0, batch_dice: bool = True,
                   ignore_label: Optional[int] = None,
                   dice_smooth: float = 1e-5) -> torch.Tensor:
    """With an ignore label both terms see only the annotated voxels."""
    target, loss_mask = _split_ignore(target, ignore_label)
    dc = memory_efficient_soft_dice_loss(logits, target, batch_dice=batch_dice, do_bg=False,
                                         smooth=dice_smooth, loss_mask=loss_mask)
    ce = cross_entropy_loss(logits, target, loss_mask)
    return weight_ce * ce + weight_dice * dc


def dc_and_bce_loss(logits: torch.Tensor, target_regions: torch.Tensor,
                    weight_ce: float = 1.0, weight_dice: float = 1.0,
                    batch_dice: bool = True, has_ignore_channel: bool = False) -> torch.Tensor:
    """Regions (sigmoid heads); with an ignore channel, the last channel of the
    target marks the unannotated voxels."""
    loss_mask = None
    if has_ignore_channel:
        loss_mask = 1.0 - target_regions[..., -1:].float()
        target_regions = target_regions[..., :-1]
    dc = memory_efficient_soft_dice_loss(logits, target_regions, batch_dice=batch_dice,
                                         do_bg=True, apply_nonlin="sigmoid",
                                         loss_mask=loss_mask)
    bce = bce_loss(logits, target_regions, loss_mask)
    return weight_ce * bce + weight_dice * dc


def dc_and_topk_loss(logits: torch.Tensor, target: torch.Tensor, weight_ce: float = 1.0,
                     weight_dice: float = 1.0, k_percent: float = 10.0,
                     batch_dice: bool = True,
                     ignore_label: Optional[int] = None) -> torch.Tensor:
    target, loss_mask = _split_ignore(target, ignore_label)
    dc = memory_efficient_soft_dice_loss(logits, target, batch_dice=batch_dice, do_bg=False,
                                         loss_mask=loss_mask)
    tk = topk_loss(logits, target, k_percent, loss_mask)
    return weight_ce * tk + weight_dice * dc


# --- deep supervision ---------------------------------------------------------

def deep_supervision_weights(num_outputs: int) -> torch.Tensor:
    """1/2^i per level, the lowest resolution's weight zeroed, normalised to 1."""
    w = torch.tensor([1 / (2 ** i) for i in range(num_outputs)], dtype=torch.float32)
    if num_outputs > 1:
        w[-1] = 0.0
    return w / w.sum()


def deep_supervision_loss(outputs: Sequence[torch.Tensor], targets: Sequence[torch.Tensor],
                          loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                          weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    if weights is None:
        weights = deep_supervision_weights(len(outputs))
    total = 0.0
    for w, o, t in zip(weights.tolist(), outputs, targets):
        total = total + w * loss_fn(o, t)
    return total


# --- hard Dice counts (validation pseudo-Dice) -----------------------------------

def hard_dice_parts(logits: torch.Tensor, target: torch.Tensor, has_regions: bool = False,
                    ignore_label: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class tp/fp/fn of the argmax (or thresholded sigmoid) prediction,
    summed over batch and space, fp32 vectors of length K (without the
    background for labels)."""
    mask = None
    if has_regions:
        pred = (torch.sigmoid(logits.float()) > 0.5).float()
        if ignore_label is not None:
            mask = 1.0 - target[..., -1:].float()
            target = target[..., :-1]
        onehot = target.float()
    else:
        k = logits.shape[-1]
        pred = _one_hot(torch.argmax(logits, -1), k)
        target, valid = _split_ignore(target, ignore_label)
        mask = None if valid is None else valid.float()
        onehot = _one_hot(target, k)
        pred, onehot = pred[..., 1:], onehot[..., 1:]
    if mask is not None:
        pred, onehot = pred * mask, onehot * mask
    axes = tuple(range(pred.ndim - 1))
    tp = (pred * onehot).sum(axes)
    fp = (pred * (1 - onehot)).sum(axes)
    fn_ = ((1 - pred) * onehot).sum(axes)
    return tp, fp, fn_


def region_targets(seg: torch.Tensor, regions: List, ignore_label: Optional[int]
                   ) -> torch.Tensor:
    """(B, *spatial) labels -> (B, *spatial, R[+1]) fp32 region one-hot, with
    the ignore channel last where there is an ignore label."""
    chans = [torch.isin(seg, torch.tensor(r if isinstance(r, (tuple, list)) else (r,),
                                          device=seg.device)).float()
             for r in regions]
    if ignore_label is not None:
        chans.append((seg == ignore_label).float())
    return torch.stack(chans, -1)

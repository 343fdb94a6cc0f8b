"""SparK masked-image-modeling model. Counterpart of anatomask_tpu/ssl/spark.py.

Layout NCDHW; masks (B, 1, f1, f2, f3) bool, True = visible. Parameter names
follow the reference torch SparK: `sparse_encoder.sp_cnn.*`, `densify_norms.{i}`,
`densify_projs.{i}`, `mask_tokens.{i}` and `dense_decoder.*`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from anatomask_torch.models.layers import ConvND
from anatomask_torch.parallel import mesh
from anatomask_torch.ssl.decoder import LightDecoder
from anatomask_torch.ssl.sparse import (SparseBatchNorm, SparseInstanceNorm, SparseLayerNorm,
                                        mask_to_resolution, upsample_mask)


def patchify(x: torch.Tensor, fmap: Sequence[int], p: Sequence[int]) -> torch.Tensor:
    """(B, C, H, W, D) -> (B, L = f1*f2*f3, p1*p2*p3*C), channel fastest within
    a patch (the JAX package's NDHWC ordering)."""
    B, C = x.shape[:2]
    (f1, f2, f3), (p1, p2, p3) = fmap, p
    x = x.reshape(B, C, f1, p1, f2, p2, f3, p3).permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(B, f1 * f2 * f3, p1 * p2 * p3 * C)


def unpatchify(x: torch.Tensor, fmap: Sequence[int], p: Sequence[int]) -> torch.Tensor:
    B, L, N = x.shape
    (f1, f2, f3), (p1, p2, p3) = fmap, p
    C = N // (p1 * p2 * p3)
    x = x.reshape(B, f1, f2, f3, p1, p2, p3, C).permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, C, f1 * p1, f2 * p2, f3 * p3)


def keep_lowest(noise: torch.Tensor, fmap: Sequence[int], len_keep: int) -> torch.Tensor:
    """Keep the len_keep lowest-noise patches: ranks by argsort of argsort
    (stable, as jnp.argsort). noise (B, L) -> mask (B, 1, f1, f2, f3)."""
    ranks = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    return (ranks < len_keep).reshape(noise.shape[0], 1, *fmap)


def random_keep_mask(batch: int, fmap: Sequence[int], len_keep: int,
                     generator: Optional[torch.Generator] = None, device="cuda",
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniformly random mask with exactly len_keep visible patches per sample.
    `noise` (B, L) uniforms replaces the draw from `generator`."""
    if noise is None:
        L = fmap[0] * fmap[1] * fmap[2]
        noise = torch.rand((batch, L), generator=generator, device=device)
    return keep_lowest(noise, fmap, len_keep)


class SparseEncoder(nn.Module):
    """Holds the masked encoder as `sp_cnn`, the reference's nesting."""

    def __init__(self, sp_cnn: nn.Module):
        super().__init__()
        self.sp_cnn = sp_cnn

    def forward(self, x, active):
        return self.sp_cnn(x, active)


def make_densify_norm(kind: str, channels: int, batch_pooled: bool,
                      dtype: torch.dtype) -> nn.Module:
    """The densify layers' norm, with the reference's epsilons: "in"
    SparseInstanceNorm (eps 1e-6, batch-pooled on request), "bn"
    SparseBatchNorm (1e-5), "ln" SparseLayerNorm (1e-6); anything else none."""
    kind = kind.lower()
    if kind == "bn":
        return SparseBatchNorm(channels, dtype=dtype)
    if kind == "ln":
        return SparseLayerNorm(channels, eps=1e-6, dtype=dtype)
    if kind == "in":
        return SparseInstanceNorm(channels, eps=1e-6, batch_pooled=batch_pooled, dtype=dtype)
    return nn.Identity()


class SparK(nn.Module):
    """Sparse encoder (STUNet or MedNeXt, with `dims` and
    `get_downsample_ratio`) + densify layers + decoder; len_keep =
    round(L * (1 - mask_ratio)) patches stay visible. densify_norm is "in",
    "bn", "ln" or none; norm_batch_pooled pools the "in" densify norms'
    statistics over the batch, as the encoder's then do.
    forward(x, active) -> (patchified input, patchified reconstruction)."""

    def __init__(self, encoder: nn.Module, decoder: LightDecoder,
                 input_size: Tuple[int, int, int], dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, mask_ratio: float = 0.6,
                 densify_norm: str = "in", norm_batch_pooled: bool = False):
        super().__init__()
        self.sparse_encoder = SparseEncoder(encoder)
        self.dense_decoder = decoder
        self.input_size = tuple(input_size)
        self.dtype = dtype
        self.mask_ratio, self.densify_norm = mask_ratio, densify_norm
        r = encoder.get_downsample_ratio()
        self.patch = (r, r, r)
        self.fmap = tuple(s // r for s in self.input_size)
        self.len_keep = round(self.fmap[0] * self.fmap[1] * self.fmap[2] * (1 - mask_ratio))

        e_widths = encoder.dims[::-1]
        d_width = decoder.width
        norms, projs, tokens = [], [], []
        for i, e_width in enumerate(e_widths):
            norms.append(make_densify_norm(densify_norm, e_width, norm_batch_pooled, dtype))
            token = torch.empty(1, e_width, 1, 1, 1)
            nn.init.trunc_normal_(token, 0.0, 0.02, -0.02, 0.02, generator=generator)
            tokens.append(nn.Parameter(token))
            if i == 0 and e_width == d_width:
                projs.append(nn.Identity())
            else:
                k = 1 if i == 0 else 3
                projs.append(ConvND(e_width, d_width, k, bias=True, dtype=dtype,
                                    generator=generator))
            d_width //= 2
        self.densify_norms = nn.ModuleList(norms)
        self.densify_projs = nn.ModuleList(projs)
        self.mask_tokens = nn.ParameterList(tokens)

    def get_config(self) -> dict:
        """The architecture keys a checkpoint is checked against on load (the
        JAX package's SparK.get_config)."""
        return {
            "mask_ratio": self.mask_ratio,
            "densify_norm_str": self.densify_norm,
            "hierarchy": len(self.densify_norms),
            "sparse_encoder.input_size": list(self.input_size),
            "dense_decoder.width": self.dense_decoder.width,
        }

    def forward(self, inp: torch.Tensor, active: torch.Tensor):
        """inp (B, C, H, W, D); active (B, 1, f1, f2, f3) bool."""
        masked = inp * upsample_mask(active, self.patch).to(inp.dtype)
        feats = self.sparse_encoder(masked, active)[::-1]  # coarsest first
        # The decoder reads one skip per block: the densify stage of the finest
        # feature is never read, so it is skipped (its parameters stay, so
        # weights carry across to and from the reference).
        n_used = len(self.dense_decoder.dec)
        cur_active = active
        to_dec = []
        for i, bcff in enumerate(feats[:n_used]):
            if not isinstance(self.densify_norms[i], nn.Identity):
                bcff = self.densify_norms[i](bcff, cur_active)
            m_here = mask_to_resolution(cur_active, bcff.shape[2:5])
            bcff = torch.where(m_here, bcff, self.mask_tokens[i].to(bcff.dtype))
            to_dec.append(self.densify_projs[i](bcff))
            cur_active = upsample_mask(cur_active, (2, 2, 2))
        rec = self.dense_decoder(to_dec)
        return patchify(inp, self.fmap, self.patch), patchify(rec, self.fmap, self.patch)


def spark_loss(inp_patches: torch.Tensor, rec_patches: torch.Tensor,
               active: torch.Tensor):
    """Per-patch-normalized L2 on the masked patches. Returns (scalar loss,
    per-patch map (B, L)); fp32, population variance as jnp.var. Under a
    process group the loss is this rank's share of the global batch's: the
    world size times its masked sum over the global masked count, so that
    the mean over the ranks is JAX's loss over the global batch."""
    inp = inp_patches.float()
    rec = rec_patches.float()
    mean = inp.mean(-1, keepdim=True)
    var = inp.var(-1, keepdim=True, correction=0)
    inp = (inp - mean) / torch.sqrt(var + 1e-6)
    l2 = (rec - inp).square().mean(2)
    non_active = 1.0 - active.reshape(active.shape[0], -1).float()
    loss_map = l2 * non_active
    if mesh.distributed():
        count = mesh.all_reduce_sum(non_active.sum())
        return loss_map.sum() * mesh.world() / (count + 1e-8), loss_map
    return loss_map.sum() / (non_active.sum() + 1e-8), loss_map


def learning_loss(loss_pred: torch.Tensor, loss_target: torch.Tensor) -> torch.Tensor:
    """MSE between a predicted loss map and the per-image-normalized target."""
    mean = loss_target.mean(1, keepdim=True)
    var = loss_target.var(1, keepdim=True, correction=0)
    target = (loss_target - mean) / torch.sqrt(var + 1e-6)
    return (loss_pred - target).square().mean()

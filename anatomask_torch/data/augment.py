"""On-device augmentation, the data-only subset that pretraining uses.
Counterpart of anatomask_tpu/data/augment.py.

The configurations and the enlarged-patch arithmetic are copies. The spatial
transform (per-axis rotation and scaling with p = 0.2 each, the crop folded
into one trilinear warp from the enlarged patch to the final patch) and the
mirroring run in torch on the batch's device. The random draws are split from
the warp: `draw_augment_params` makes the matrices, the identity flags and the
mirror flags on the host from a `torch.Generator`; `spatial_augment` and
`mirror` take them as inputs, so that a test can hand both packages the same.

Not ported until the supervised path needs them: non-zero intensity
probabilities, elastic warps, order-0 and order-3 data warps, seg warps and
the DA5 stack; `make_train_augment_fn` raises NotImplementedError for them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


# --- configuration ------------------------------------------------------------

@dataclass(frozen=True)
class SpatialAugmentConfig:
    patch_size: Tuple[int, ...]                 # final (network) patch
    rotation_x: Tuple[float, float] = (-np.pi / 6, np.pi / 6)
    rotation_y: Tuple[float, float] = (-np.pi / 6, np.pi / 6)
    rotation_z: Tuple[float, float] = (-np.pi / 6, np.pi / 6)
    p_rotation: float = 0.2
    scale_range: Tuple[float, float] = (0.7, 1.4)
    p_scaling: float = 0.2
    dummy_2d: bool = False                      # rotate in-plane only, keep axis 0
    p_elastic: float = 0.0
    elastic_magnitude: Tuple[float, float] = (0.0, 0.2)  # fraction of patch size
    elastic_grid: int = 4                       # coarse control-point grid
    data_interpolation_order0: bool = False     # nearest for data
    data_interpolation_order: int = 1           # 1 = trilinear, 3 = cubic B-spline
    seg_labels: Optional[Tuple[int, ...]] = None


@dataclass(frozen=True)
class IntensityAugmentConfig:
    p_noise: float = 0.1
    noise_variance: Tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    p_blur_per_channel: float = 0.5
    blur_sigma: Tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: Tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: Tuple[float, float] = (0.75, 1.25)
    p_lowres: float = 0.25
    p_lowres_per_channel: float = 0.5
    lowres_zoom: Tuple[float, float] = (0.5, 1.0)
    lowres_ignore_axis0: bool = False           # dummy-2D: don't degrade axis 0
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: Tuple[float, float] = (0.7, 1.5)


@dataclass(frozen=True)
class AugmentConfig:
    spatial: SpatialAugmentConfig
    intensity: IntensityAugmentConfig = field(default_factory=IntensityAugmentConfig)
    da5: Optional[object] = None
    mirror_axes: Tuple[int, ...] = (0, 1, 2)
    mask_channels_for_norm: Tuple[int, ...] = ()   # channels zeroed outside nonzero mask
    ds_scales: Tuple[Tuple[int, ...], ...] = ()    # per-DS-level integer downsample factors
    cascade_foreground_labels: Tuple[int, ...] = ()


def rotation_ranges_and_initial_patch_size(
    patch_size: Sequence[int],
) -> Tuple[dict, bool, np.ndarray, Tuple[int, ...]]:
    """nnU-Net's configure_rotation_dummyDA_mirroring_and_inital_patch_size:
    anisotropic patches use in-plane-only (dummy-2D) rotation; the sampled
    patch is enlarged so rotation+scaling never read outside it."""
    patch_size = list(patch_size)
    if len(patch_size) == 3 and patch_size[0] == 1:
        # promoted-2D configuration: apply the 2D rules in-plane, no enlargement
        # along the singleton axis
        rot, dummy, initial, mirror_axes = rotation_ranges_and_initial_patch_size(patch_size[1:])
        return rot, True, np.array([1, *initial]), (1, 2)
    dim = len(patch_size)
    if dim == 2:
        do_dummy_2d = False
        if max(patch_size) / min(patch_size) > 1.5:
            rot = {"x": (-np.pi / 12, np.pi / 12), "y": (0.0, 0.0), "z": (0.0, 0.0)}
        else:
            rot = {"x": (-np.pi, np.pi), "y": (0.0, 0.0), "z": (0.0, 0.0)}
        mirror_axes = (0, 1)
    elif dim == 3:
        do_dummy_2d = (max(patch_size) / patch_size[0]) > 3
        if do_dummy_2d:
            rot = {"x": (-np.pi, np.pi), "y": (0.0, 0.0), "z": (0.0, 0.0)}
        else:
            rot = {"x": (-np.pi / 6, np.pi / 6), "y": (-np.pi / 6, np.pi / 6),
                   "z": (-np.pi / 6, np.pi / 6)}
        mirror_axes = (0, 1, 2)
    else:
        raise RuntimeError(f"unsupported dim {dim}")
    initial = compute_initial_patch_size(patch_size[-dim:], rot["x"], rot["y"], rot["z"], (0.85, 1.25))
    if do_dummy_2d:
        initial[0] = patch_size[0]
    return rot, do_dummy_2d, initial, mirror_axes


def _rot3d(coords: np.ndarray, ax: float, ay: float, az: float) -> np.ndarray:
    cx, sx = np.cos(ax), np.sin(ax)
    cy, sy = np.cos(ay), np.sin(ay)
    cz, sz = np.cos(az), np.sin(az)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Rx @ Ry @ Rz) @ coords


def compute_initial_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range) -> np.ndarray:
    """Enlarge the sampled patch so worst-case rotation+zoom stays inside it."""
    rx = min(np.pi / 2, max(np.abs(rot_x)) if isinstance(rot_x, (tuple, list)) else rot_x)
    ry = min(np.pi / 2, max(np.abs(rot_y)) if isinstance(rot_y, (tuple, list)) else rot_y)
    rz = min(np.pi / 2, max(np.abs(rot_z)) if isinstance(rot_z, (tuple, list)) else rot_z)
    coords = np.array(final_patch_size, dtype=float)
    final = coords.copy()
    if len(coords) == 3:
        final = np.maximum(np.abs(_rot3d(coords, rx, 0, 0)), final)
        final = np.maximum(np.abs(_rot3d(coords, 0, ry, 0)), final)
        final = np.maximum(np.abs(_rot3d(coords, 0, 0, rz)), final)
    else:
        c, s = np.cos(rx), np.sin(rx)
        final = np.maximum(np.abs(np.array([[c, -s], [s, c]]) @ coords), final)
    final /= min(scale_range)
    return final.astype(int)


# --- random draws (host) ------------------------------------------------------

def _uniform(gen: torch.Generator, n: int, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen)


def _affine_matrices(gen: torch.Generator, batch: int, cfg: SpatialAugmentConfig):
    """Per-sample 3x3 matrices mapping centered OUTPUT coords -> centered INPUT
    coords (rotation + zoom; zoom > 1 shrinks content), fp32 on the host, and
    the per-sample identity flag (neither rotation nor scaling drawn: the warp
    is a central crop)."""
    ax = _uniform(gen, batch, *cfg.rotation_x)
    ay = _uniform(gen, batch, *cfg.rotation_y)
    az = _uniform(gen, batch, *cfg.rotation_z)
    do_rot = torch.rand(batch, generator=gen) < float(cfg.p_rotation)
    ax, ay, az = (torch.where(do_rot, a, 0.0) for a in (ax, ay, az))
    sc = _uniform(gen, batch, *cfg.scale_range)
    do_sc = torch.rand(batch, generator=gen) < float(cfg.p_scaling)
    sc = torch.where(do_sc, sc, 1.0)
    ident = ~(do_rot | do_sc)

    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    zero, one = torch.zeros_like(cx), torch.ones_like(cx)
    Rx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(batch, 3, 3)
    Ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(batch, 3, 3)
    Rz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(batch, 3, 3)
    if cfg.dummy_2d:
        # rotate in-plane (around axis 0) only; axis 0 passes through unscaled
        S = torch.stack([one, zero, zero, zero, sc, zero, zero, zero, sc], -1).reshape(batch, 3, 3)
        R = Rx
    else:
        S = sc[:, None, None] * torch.eye(3).expand(batch, 3, 3)
        R = Rx @ Ry @ Rz
    return R @ S, ident


def draw_augment_params(gen: torch.Generator, batch: int, cfg: "AugmentConfig"):
    """(A (B, 3, 3) fp32, ident (B,) bool, mirror flags (B, len(mirror_axes))
    bool), all on the host."""
    A, ident = _affine_matrices(gen, batch, cfg.spatial)
    flags = torch.rand((batch, len(cfg.mirror_axes)), generator=gen) < 0.5
    return A, ident, flags


# --- spatial warp (device) ----------------------------------------------------

def _trilinear_sample(vol: torch.Tensor, pos: torch.Tensor, cval: float = 0.0) -> torch.Tensor:
    """vol (X, Y, Z) fp32; pos (3, ox, oy, oz) absolute input coords ->
    (ox, oy, oz): scipy map_coordinates(order=1, mode='constant') by 8 gathers,
    corners outside the volume reading `cval`."""
    X, Y, Z = vol.shape
    f0 = torch.floor(pos)
    t = pos - f0
    base = f0.long()
    flat = vol.reshape(-1)

    def taps(b, n):
        return [((b + o).clamp(0, n - 1), (b + o >= 0) & (b + o < n)) for o in (0, 1)]

    xs, ys, zs = taps(base[0], X), taps(base[1], Y), taps(base[2], Z)
    wx, wy, wz = ([1.0 - t[d], t[d]] for d in range(3))
    acc = torch.zeros(pos.shape[1:], dtype=vol.dtype, device=vol.device)
    for i in range(2):
        xi, okx = xs[i]
        part = None
        for j in range(2):
            yj, oky = ys[j]
            for k in range(2):
                zk, okz = zs[k]
                vals = torch.where(okx & oky & okz, flat[(xi * Y + yj) * Z + zk], cval)
                term = vals * (wy[j] * wz[k])
                part = term if part is None else part + term
        acc = acc + wx[i] * part
    return acc


def _identity_crop(x: torch.Tensor, out_shape) -> torch.Tensor:
    """What the warp computes when A == I, as slices: the identity warp samples
    at static offsets ((in_k - out_k)/2 per axis), integers or half-integers
    by construction, so a central crop plus a 2-tap average along axes where
    in_k - out_k is odd (exact in fp32). x (ix, iy, iz[, C]); returns fp32."""
    x = x.float()
    for ax, o in enumerate(out_shape):
        i = int(x.shape[ax])
        i0 = (i - o) // 2
        if (i - o) % 2 == 0:
            x = x.narrow(ax, i0, o)
        else:
            x = 0.5 * (x.narrow(ax, i0, o) + x.narrow(ax, i0 + 1, o))
    return x


def spatial_augment(data: torch.Tensor, A: torch.Tensor, ident: torch.Tensor,
                    cfg: SpatialAugmentConfig) -> torch.Tensor:
    """data (B, ix, iy, iz, C) float on its device; A (B, 3, 3) and ident (B,)
    from `_affine_matrices`. Returns the final-patch-size warp (B, *patch, C)
    fp32: a central crop for identity samples, the trilinear warp otherwise."""
    batch = data.shape[0]
    in_shape = tuple(data.shape[1:4])
    out_shape = tuple(int(s) for s in cfg.patch_size)
    dev = data.device
    base = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=dev) - (s - 1) / 2 for s in out_shape],
        indexing="ij"))  # (3, ox, oy, oz), centered
    center_in = torch.tensor([(s - 1) / 2 for s in in_shape], dtype=torch.float32, device=dev)
    crop_ok = all(i >= o for i, o in zip(in_shape, out_shape))
    A = A.to(dev, torch.float32)
    out = []
    for b in range(batch):
        if bool(ident[b]) and crop_ok:
            out.append(_identity_crop(data[b], out_shape))
            continue
        pos = torch.einsum("ij,jxyz->ixyz", A[b], base) + center_in[:, None, None, None]
        d = data[b].float()
        out.append(torch.stack([_trilinear_sample(d[..., c], pos) for c in range(d.shape[-1])],
                               dim=-1))
    return torch.stack(out)


def mirror(data: torch.Tensor, flags: torch.Tensor, mirror_axes: Sequence[int]) -> torch.Tensor:
    """data (B, x, y, z, C); flags (B, len(mirror_axes)) bool on the host:
    sample b is flipped along mirror_axes[i] where flags[b, i]."""
    out = []
    for b in range(data.shape[0]):
        dims = [ax for i, ax in enumerate(mirror_axes) if bool(flags[b, i])]
        out.append(data[b].flip(dims) if dims else data[b])
    return torch.stack(out)


# --- full pipeline ------------------------------------------------------------

def _check_supported(cfg: AugmentConfig) -> None:
    ic, sp = cfg.intensity, cfg.spatial
    probs = (ic.p_noise, ic.p_blur, ic.p_brightness, ic.p_contrast, ic.p_lowres,
             ic.p_gamma_invert, ic.p_gamma)
    unported = {
        "non-zero intensity probabilities": any(p > 0 for p in probs),
        "elastic warps": sp.p_elastic > 0,
        "order-0 data warps": sp.data_interpolation_order0,
        "order-3 data warps": int(sp.data_interpolation_order) != 1,
        "seg warps": bool(sp.seg_labels),
        "the DA5 stack": cfg.da5 is not None,
    }
    missing = [k for k, v in unported.items() if v]
    if missing:
        raise NotImplementedError(
            f"augmentation with {', '.join(missing)} is not ported to anatomask_torch yet "
            f"(it comes with the supervised path, ROADMAP.md)")


def make_train_augment_fn(cfg: AugmentConfig):
    """Returns fn(generator, data (B, ix, iy, iz, C), seg=None) ->
    (data (B, *patch, C) fp32, None): the spatial warp, then mirroring. The
    draws come from `generator` (a CPU torch.Generator); the work runs on
    data's device."""
    _check_supported(cfg)

    def augment(gen: torch.Generator, data: torch.Tensor, seg=None):
        if seg is not None:
            raise NotImplementedError("seg warps are not ported to anatomask_torch yet")
        A, ident, flags = draw_augment_params(gen, data.shape[0], cfg)
        data = spatial_augment(data, A, ident, cfg.spatial)
        if cfg.mirror_axes:
            data = mirror(data, flags, cfg.mirror_axes)
        return data, None

    return augment

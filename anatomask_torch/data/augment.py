"""On-device augmentation. Counterpart of anatomask_tpu/data/augment.py
(nnU-Net's training transforms: spatial transform, Gaussian noise and blur,
brightness, contrast, low resolution, the two gammas, DA5's extras
(`data/augment_da5.py`), mirroring, the mask-for-norm zeroing, RemoveLabel,
the cascade one-hot and the deep-supervision seg pyramid).

The configurations and the enlarged-patch arithmetic are copies. The
transforms run in torch on the batch's device, in fp32 whatever the transfer
dtype. The random draws are split from the work: `draw_augment_params`,
`draw_elastic` and `draw_intensity_params` make every parameter on the host
from a `torch.Generator`, and each transform takes them as inputs, so that a
test can hand both packages the same draws. Only the Gaussian noise field is
drawn on the batch's device, from a seed the host generator draws. Where JAX
computes a transform for the whole batch and selects per sample or channel
with `where`, the port computes it only where the flag is set (the same
values).

The spatial transform folds the crop from the enlarged patch into one warp:
a central crop where neither rotation nor scaling was drawn (order-1 data,
no elastic field, as JAX's identity fast path), else a trilinear (order 1),
nearest (order 0) or cubic B-spline (order 3) data warp, with the seg warped
per label (each label's indicator interpolated linearly and thresholded at
0.5, later labels overwriting, -1 outside the input) or, for order-0 data,
by nearest. With DA5 (`AugmentConfig.da5` a `DA5Config`), blur,
multiplicative brightness and contrast are left to DA5's own variants, and
its extras run after the two gammas and before mirroring, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as fn


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
    da5: Optional[object] = None                # augment_da5.DA5Config: nnUNetTrainerDA5
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

def _uniform(gen: torch.Generator, n, lo: float, hi: float) -> torch.Tensor:
    shape = (n,) if isinstance(n, int) else tuple(n)
    return lo + (hi - lo) * torch.rand(shape, generator=gen)


def _bernoulli(gen: torch.Generator, p: float, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen) < float(p)


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


def draw_elastic(gen: torch.Generator, batch: int, cfg: SpatialAugmentConfig):
    """The elastic field's draws: the coarse control grid (B, g, g, g, 3) of
    standard normals, the magnitude (B,) and the per-sample flag (B,)."""
    g = cfg.elastic_grid
    coarse = torch.randn((batch, g, g, g, 3), generator=gen)
    mag = _uniform(gen, batch, *cfg.elastic_magnitude)
    return coarse, mag, _bernoulli(gen, cfg.p_elastic, batch)


def draw_intensity_params(gen: torch.Generator, batch: int, channels: int,
                          cfg: IntensityAugmentConfig) -> Dict[str, torch.Tensor]:
    """Every intensity transform's draws, as JAX's functions draw them:
    per-sample flags (B,) or per-(sample, channel) flags (B, C) and values."""
    bc = (batch, channels)
    lo, hi = float(cfg.contrast_range[0]), float(cfg.contrast_range[1])
    f_lo = _uniform(gen, bc, lo, min(1.0, hi))
    f_hi = _uniform(gen, bc, max(lo, 1.0), hi)
    pick_lo = _bernoulli(gen, 0.5, bc)

    def gamma():
        lo_side = _bernoulli(gen, 0.5, bc)
        u = torch.rand(bc, generator=gen)
        g_lo = cfg.gamma_range[0] + u * (1 - cfg.gamma_range[0])
        g_hi = 1 + u * (cfg.gamma_range[1] - 1)
        return torch.where(lo_side, g_lo, g_hi)

    return {
        "noise_std": _uniform(gen, batch, *cfg.noise_variance),
        "noise_on": _bernoulli(gen, cfg.p_noise, batch),
        "blur_sigma": _uniform(gen, bc, *cfg.blur_sigma),
        "blur_on": (_bernoulli(gen, cfg.p_blur, (batch, 1))
                    & _bernoulli(gen, cfg.p_blur_per_channel, bc)),
        "brightness": _uniform(gen, bc, *cfg.brightness_range),
        "brightness_on": _bernoulli(gen, cfg.p_brightness, batch),
        "contrast": torch.where(pick_lo & (lo < 1.0), f_lo, f_hi),
        "contrast_on": _bernoulli(gen, cfg.p_contrast, batch),
        "lowres_zoom": _uniform(gen, bc, *cfg.lowres_zoom),
        "lowres_on": (_bernoulli(gen, cfg.p_lowres, (batch, 1))
                      & _bernoulli(gen, cfg.p_lowres_per_channel, bc)),
        "gamma_invert": gamma(),
        "gamma_invert_on": _bernoulli(gen, cfg.p_gamma_invert, batch),
        "gamma": gamma(),
        "gamma_on": _bernoulli(gen, cfg.p_gamma, batch),
    }


# --- spatial warp (device) ----------------------------------------------------

def _taps(base: torch.Tensor, n: int, count: int):
    """[(index clamped into [0, n), in bounds)] for base + 0 .. count - 1."""
    return [((base + o).clamp(0, n - 1), (base + o >= 0) & (base + o < n))
            for o in range(count)]


def _trilinear_sample(vol: torch.Tensor, pos: torch.Tensor, cval: float = 0.0) -> torch.Tensor:
    """vol (X, Y, Z) fp32; pos (3, ox, oy, oz) absolute input coords ->
    (ox, oy, oz): scipy map_coordinates(order=1, mode='constant') by 8 gathers,
    corners outside the volume reading `cval`."""
    X, Y, Z = vol.shape
    f0 = torch.floor(pos)
    t = pos - f0
    base = f0.long()
    flat = vol.reshape(-1)
    xs, ys, zs = _taps(base[0], X, 2), _taps(base[1], Y, 2), _taps(base[2], Z, 2)
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


def _nearest_sample(vol: torch.Tensor, pos: torch.Tensor, cval: float) -> torch.Tensor:
    """map_coordinates(order=0, mode='constant') at pos rounded half to even,
    as JAX's `_nearest_sample`."""
    X, Y, Z = vol.shape
    idx = torch.round(pos).long()
    ok = ((idx >= 0) & (idx < torch.tensor([X, Y, Z], device=pos.device)[:, None, None, None])
          ).all(0)
    xi, yi, zi = (idx[d].clamp(0, n - 1) for d, n in enumerate((X, Y, Z)))
    return torch.where(ok, vol.reshape(-1)[(xi * Y + yi) * Z + zi], cval)


# cubic B-spline prefilter pole (sqrt(3) - 2); JAX approximates the recursive
# filter by its truncated symmetric impulse response, DC-normalised
_SPLINE_POLE = -0.26794919243112270647
_SPLINE_RADIUS = 12


def _pad_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Indices of a length-n axis padded by r on both sides as numpy's
    'reflect' (d c b | a b c d) or 'symmetric' (c b a | a b c) pads it."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "symmetric":
        i = i % (2 * n)
        return torch.where(i >= n, 2 * n - 1 - i, i)
    period = max(1, 2 * (n - 1))
    i = i % period
    return torch.where(i > n - 1, period - i, i)


def _filter_axes(vol: torch.Tensor, kernel: torch.Tensor, mode: str, axes) -> torch.Tensor:
    """The symmetric odd-length 1D `kernel` along each of `axes` of vol in
    turn, the borders padded by `mode`."""
    r = kernel.shape[0] // 2
    w = kernel.to(vol.device, vol.dtype).view(1, 1, -1)
    for ax in axes:
        moved = vol.movedim(ax, -1)
        n = moved.shape[-1]
        padded = moved.index_select(-1, _pad_index(n, r, mode, vol.device))
        out = fn.conv1d(padded.reshape(-1, 1, n + 2 * r), w).reshape(moved.shape)
        vol = out.movedim(-1, ax)
    return vol


def _spline_prefilter(vol: torch.Tensor) -> torch.Tensor:
    n = np.arange(-_SPLINE_RADIUS, _SPLINE_RADIUS + 1)
    h = (-6.0 * _SPLINE_POLE / (1.0 - _SPLINE_POLE ** 2)) * (_SPLINE_POLE ** np.abs(n))
    h = torch.tensor(h / h.sum(), dtype=torch.float32)
    return _filter_axes(vol, h, "reflect", range(3))


def _cubic_sample(vol: torch.Tensor, pos: torch.Tensor, cval: float) -> torch.Tensor:
    """Order-3 B-spline sampling of (X, Y, Z) at pos (3, ...): the prefilter,
    then the 4x4x4 neighbourhood, corners outside the volume reading `cval`."""
    vol = _spline_prefilter(vol.float())
    X, Y, Z = vol.shape
    f0 = torch.floor(pos)
    t = pos - f0
    base = f0.long() - 1

    def wts(f):
        f2 = f * f
        f3 = f2 * f
        return [(1 - f) ** 3 / 6.0, (3 * f3 - 6 * f2 + 4) / 6.0,
                (-3 * f3 + 3 * f2 + 3 * f + 1) / 6.0, f3 / 6.0]

    xs, ys, zs = _taps(base[0], X, 4), _taps(base[1], Y, 4), _taps(base[2], Z, 4)
    wx, wy, wz = wts(t[0]), wts(t[1]), wts(t[2])
    flat = vol.reshape(-1)
    acc = torch.zeros(pos.shape[1:], dtype=torch.float32, device=vol.device)
    for i in range(4):
        xi, okx = xs[i]
        part = None
        for j in range(4):
            yj, oky = ys[j]
            for k in range(4):
                zk, okz = zs[k]
                vals = torch.where(okx & oky & okz, flat[(xi * Y + yj) * Z + zk], cval)
                term = vals * (wy[j] * wz[k])
                part = term if part is None else part + term
        acc = acc + wx[i] * part
    return acc


def _seg_per_label_sample(vol: torch.Tensor, pos: torch.Tensor,
                          labels: Sequence[int]) -> torch.Tensor:
    """nnU-Net's order-1 seg warp: each label's indicator warped trilinearly
    (corners outside the volume reading -1), the label set where it reaches
    0.5, later labels overwriting; 0 elsewhere. The 8 corners of the label
    volume are gathered once and every label's interpolation is summed from
    them, in the order `_trilinear_sample` sums (as JAX's shared-corner
    form)."""
    X, Y, Z = vol.shape
    f0 = torch.floor(pos)
    t = pos - f0
    base = f0.long()
    flat = vol.float().reshape(-1)
    xs, ys, zs = _taps(base[0], X, 2), _taps(base[1], Y, 2), _taps(base[2], Z, 2)
    wx, wy, wz = ([1.0 - t[d], t[d]] for d in range(3))
    corners = []  # (x tap, [(labels at the corner, in bounds, weight)])
    for i in range(2):
        xi, okx = xs[i]
        yz = []
        for j in range(2):
            yj, oky = ys[j]
            for k in range(2):
                zk, okz = zs[k]
                yz.append((flat[(xi * Y + yj) * Z + zk], okx & oky & okz, wy[j] * wz[k]))
        corners.append(yz)
    out = torch.zeros(pos.shape[1:], dtype=torch.float32, device=vol.device)
    for cl in sorted(labels):
        acc = torch.zeros_like(out)
        for i in range(2):
            part = None
            for segv, ok, w in corners[i]:
                term = torch.where(ok, (segv == float(cl)).float(), -1.0) * w
                part = term if part is None else part + term
            acc = acc + wx[i] * part
        out = torch.where(acc >= 0.5, float(cl), out)
    return out


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


def _identity_seg(vol: torch.Tensor, out_shape, labels: Sequence[int]) -> torch.Tensor:
    """_seg_per_label_sample at the identity warp: each label's indicator
    cropped (2-tap averages are exact), thresholded at 0.5, later labels
    overwriting. vol (ix, iy, iz)."""
    out = torch.zeros(tuple(out_shape), dtype=torch.float32, device=vol.device)
    for cl in sorted(labels):
        r = _identity_crop((vol == float(cl)).float(), out_shape)
        out = torch.where(r >= 0.5, float(cl), out)
    return out


def elastic_displacement(coarse: torch.Tensor, mag: torch.Tensor, on: torch.Tensor,
                         out_shape, device) -> torch.Tensor:
    """The smooth displacement field (B, 3, ox, oy, oz) in voxels: the coarse
    grid resized linearly with half-pixel centres (jax.image.resize), times
    the magnitude where the sample's flag is set, times the patch size per
    axis."""
    field = fn.interpolate(coarse.to(device).permute(0, 4, 1, 2, 3), size=tuple(out_shape),
                           mode="trilinear", align_corners=False)
    scaled = field * mag.to(device)[:, None, None, None, None]
    disp = torch.where(on.to(device)[:, None, None, None, None], scaled, 0.0)
    return disp * torch.tensor(list(out_shape), dtype=torch.float32,
                               device=device)[None, :, None, None, None]


def _use_identity(cfg: SpatialAugmentConfig, in_shape, out_shape, disp, with_seg: bool) -> bool:
    """JAX's identity fast path: order-1 data, no elastic field, p < 1, an
    input no smaller than the output, and per-label seg warps if any seg."""
    return (disp is None and not cfg.data_interpolation_order0
            and int(cfg.data_interpolation_order) == 1
            and cfg.p_rotation < 1.0 and cfg.p_scaling < 1.0
            and all(i >= o for i, o in zip(in_shape, out_shape))
            and (not with_seg or bool(cfg.seg_labels)))


def _positions(A: torch.Tensor, in_shape, out_shape, device) -> List[torch.Tensor]:
    """Per sample, the absolute input coordinates (3, ox, oy, oz) that the
    output voxels sample: A[i, 0] x + A[i, 1] y + A[i, 2] z + centre_i of the
    centred output grid, one elementwise op at a time, so that the card and
    the CPU round them alike (a matmul's summation order is its library's)."""
    grid = torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=device) - (s - 1) / 2 for s in out_shape],
        indexing="ij")  # centered
    A = A.to(torch.float32)
    out = []
    for b in range(A.shape[0]):
        rows = []
        for i, s in enumerate(in_shape):
            a = A[b, i].tolist()
            rows.append(a[0] * grid[0] + a[1] * grid[1] + a[2] * grid[2] + (s - 1) / 2)
        out.append(torch.stack(rows))
    return out


def spatial_augment(data: torch.Tensor, A: torch.Tensor, ident: torch.Tensor,
                    cfg: SpatialAugmentConfig, seg: Optional[torch.Tensor] = None,
                    disp: Optional[torch.Tensor] = None):
    """data (B, ix, iy, iz, C) float on its device; A (B, 3, 3) and ident (B,)
    from `_affine_matrices`; seg (B, ix, iy, iz, S) int or None; disp the
    elastic field (B, 3, ox, oy, oz) or None. Returns the final-patch-size
    warp (B, *patch, C) fp32, and with a seg the pair (data, seg (B, *patch,
    S) int16)."""
    in_shape = tuple(data.shape[1:4])
    out_shape = tuple(int(s) for s in cfg.patch_size)
    dev = data.device
    use_ident = _use_identity(cfg, in_shape, out_shape, disp, seg is not None)
    if cfg.data_interpolation_order0:
        data_sample = _nearest_sample
    elif int(cfg.data_interpolation_order) == 3:
        data_sample = _cubic_sample
    else:
        data_sample = _trilinear_sample
    positions = None
    d_out, s_out = [], []
    for b in range(data.shape[0]):
        if use_ident and bool(ident[b]):
            d_out.append(_identity_crop(data[b], out_shape))
            if seg is not None:
                s_out.append(torch.stack([_identity_seg(seg[b, ..., c], out_shape,
                                                        cfg.seg_labels)
                                          for c in range(seg.shape[-1])], -1))
            continue
        if positions is None:
            positions = _positions(A, in_shape, out_shape, dev)
        pos = positions[b] if disp is None else positions[b] + disp[b]
        d = data[b].float()
        d_out.append(torch.stack([data_sample(d[..., c], pos, 0.0) for c in range(d.shape[-1])],
                                 dim=-1))
        if seg is not None:
            sv = seg[b].float()
            s_out.append(torch.stack(
                [_seg_per_label_sample(sv[..., c], pos, cfg.seg_labels) if cfg.seg_labels
                 else _nearest_sample(sv[..., c], pos, -1.0) for c in range(sv.shape[-1])], -1))
    data_out = torch.stack(d_out)
    if seg is None:
        return data_out
    return data_out, torch.stack(s_out).to(torch.int16)


# --- intensity transforms (device) --------------------------------------------
# x (B, X, Y, Z, C) fp32 on its device; flags and values on the host. Each
# returns a new tensor and leaves x as it is.

def gaussian_noise(x: torch.Tensor, std: torch.Tensor, on: torch.Tensor,
                   noise: Optional[torch.Tensor]) -> torch.Tensor:
    """x + noise * std where the sample's flag is set (noise: standard normals
    of x's shape). The drawn value is the std (batchgenerators'
    noise_variance is one by name only)."""
    out = x.clone()
    for b in torch.nonzero(on).flatten().tolist():
        out[b] = x[b] + noise[b] * float(std[b])
    return out


def _gaussian_kernel1d(sigma: float, radius: int = 4) -> torch.Tensor:
    t = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (t / torch.clamp(torch.tensor(sigma, dtype=torch.float32),
                                           min=1e-3)) ** 2)
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, sigma: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur (radius 4, scipy's default 'reflect' border,
    numpy's 'symmetric') of each (sample, channel) whose flag is set."""
    out = x.clone()
    for b, c in torch.nonzero(on).tolist():
        out[b, ..., c] = _filter_axes(x[b, ..., c], _gaussian_kernel1d(float(sigma[b, c])),
                                      "symmetric", range(3))
    return out


def brightness_multiplicative(x: torch.Tensor, mult: torch.Tensor,
                              on: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for b in torch.nonzero(on).flatten().tolist():
        out[b] = x[b] * mult[b].to(x.device)
    return out


def contrast(x: torch.Tensor, factor: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Mean-preserving contrast scaling per channel, clipped back to the
    channel's range."""
    out = x.clone()
    for b in torch.nonzero(on).flatten().tolist():
        v = x[b]
        axes = (0, 1, 2)
        mn, mx = v.amin(axes, keepdim=True), v.amax(axes, keepdim=True)
        mean = v.mean(axes, keepdim=True)
        out[b] = torch.minimum(torch.maximum((v - mean) * factor[b].to(x.device) + mean, mn), mx)
    return out


def _lowres_volume(vol: torch.Tensor, zoom: float, ignore_axis0: bool) -> torch.Tensor:
    """Nearest 'downsample' to a grid of pitch 1/zoom and linear 'upsample'
    back, as one fixed-shape resample per axis (skimage's half-pixel
    centres; JAX's linear upsample)."""
    z = torch.tensor(zoom, dtype=torch.float32, device=vol.device)
    out = vol
    for ax in range(1 if ignore_axis0 else 0, 3):
        n = out.shape[ax]
        i = torch.arange(n, dtype=torch.float32, device=vol.device)
        p = (i + 0.5) * z - 0.5
        j0 = torch.floor(p)
        frac = p - j0
        src0 = torch.floor((j0 + 0.5) / z).clamp(0, n - 1).long()
        src1 = torch.floor((j0 + 1.5) / z).clamp(0, n - 1).long()
        moved = out.movedim(ax, 0)
        f = frac.reshape(-1, *([1] * (moved.ndim - 1)))
        out = (moved[src0] * (1 - f) + moved[src1] * f).movedim(0, ax)
    return out


def simulate_lowres(x: torch.Tensor, zoom: torch.Tensor, on: torch.Tensor,
                    ignore_axis0: bool = False) -> torch.Tensor:
    out = x.clone()
    for b, c in torch.nonzero(on).tolist():
        out[b, ..., c] = _lowres_volume(x[b, ..., c], float(zoom[b, c]), ignore_axis0)
    return out


def gamma_transform(x: torch.Tensor, gamma: torch.Tensor, on: torch.Tensor,
                    invert: bool) -> torch.Tensor:
    """Gamma with retained statistics (mean and std per channel), on -x and
    negated back when `invert`."""
    out = x.clone()
    axes = (0, 1, 2)
    for b in torch.nonzero(on).flatten().tolist():
        y = -x[b] if invert else x[b]
        mean = y.mean(axes, keepdim=True)
        sd = y.std(axes, keepdim=True, correction=0)
        mn = y.amin(axes, keepdim=True)
        rnge = y.amax(axes, keepdim=True) - mn
        g = gamma[b].to(x.device)
        yt = torch.pow(((y - mn) / (rnge + 1e-7)).clamp(0, 1), g) * (rnge + 1e-7) + mn
        yt = ((yt - yt.mean(axes, keepdim=True))
              / (yt.std(axes, keepdim=True, correction=0) + 1e-8) * sd + mean)
        out[b] = -yt if invert else yt
    return out


def apply_intensity(x: torch.Tensor, p: Dict[str, torch.Tensor],
                    noise: Optional[torch.Tensor], cfg: IntensityAugmentConfig,
                    da5: bool = False) -> torch.Tensor:
    """The transforms in nnU-Net's order: noise, blur, brightness, contrast,
    low resolution, inverted gamma, gamma; with `da5`, without blur,
    brightness and contrast (DA5 replaces them with its own variants)."""
    x = gaussian_noise(x, p["noise_std"], p["noise_on"], noise)
    if not da5:
        x = gaussian_blur(x, p["blur_sigma"], p["blur_on"])
        x = brightness_multiplicative(x, p["brightness"], p["brightness_on"])
        x = contrast(x, p["contrast"], p["contrast_on"])
    x = simulate_lowres(x, p["lowres_zoom"], p["lowres_on"], cfg.lowres_ignore_axis0)
    x = gamma_transform(x, p["gamma_invert"], p["gamma_invert_on"], True)
    return gamma_transform(x, p["gamma"], p["gamma_on"], False)


def mirror(data: torch.Tensor, flags: torch.Tensor, mirror_axes: Sequence[int]) -> torch.Tensor:
    """data (B, x, y, z, C); flags (B, len(mirror_axes)) bool on the host:
    sample b is flipped along mirror_axes[i] where flags[b, i]."""
    out = []
    for b in range(data.shape[0]):
        dims = [ax for i, ax in enumerate(mirror_axes) if bool(flags[b, i])]
        out.append(data[b].flip(dims) if dims else data[b])
    return torch.stack(out)


def downsample_seg_for_ds(seg: torch.Tensor, ds_scales) -> List[torch.Tensor]:
    """Nearest-downsample the (B, x, y, z, S) seg to each deep-supervision
    scale at floor((i + 0.5) * f) (scipy/skimage's order-0 tie rule)."""
    out = []
    for factors in ds_scales:
        s = seg
        for ax, f in enumerate(factors):
            if f == 1:
                continue
            n = s.shape[ax + 1]
            idx = np.clip(np.floor((np.arange(n // f) + 0.5) * f), 0, n - 1).astype(np.int64)
            s = s.index_select(ax + 1, torch.from_numpy(idx).to(s.device))
        out.append(s)
    return out


# --- full pipelines -----------------------------------------------------------

@dataclass
class AugmentDraws:
    """Every draw of one batch's augmentation: the spatial matrices, identity
    and mirror flags, the elastic field's draws (or None), the intensity
    parameters (or None where every probability is 0), the noise field
    (B, *patch, C) on the data's device (or None where no sample adds noise)
    and DA5's draws (`augment_da5.draw_da5`, or None without DA5)."""
    A: torch.Tensor
    ident: torch.Tensor
    mirror: torch.Tensor
    elastic: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
    intensity: Optional[Dict[str, torch.Tensor]] = None
    noise: Optional[torch.Tensor] = None
    da5: Optional[Dict[str, object]] = None


def _intensity_on(cfg: IntensityAugmentConfig) -> bool:
    return any(p > 0 for p in (cfg.p_noise, cfg.p_blur, cfg.p_brightness, cfg.p_contrast,
                               cfg.p_lowres, cfg.p_gamma_invert, cfg.p_gamma))


def draw_all(gen: torch.Generator, data: torch.Tensor, cfg: "AugmentConfig",
             batch: Optional[int] = None) -> AugmentDraws:
    """Every draw of one batch of `batch` samples (default data's) from `gen`
    (a CPU generator); the noise field comes from a generator on the data's
    device seeded from `gen`."""
    batch = data.shape[0] if batch is None else batch
    A, ident, flags = draw_augment_params(gen, batch, cfg)
    draws = AugmentDraws(A, ident, flags)
    if cfg.spatial.p_elastic > 0:
        draws.elastic = draw_elastic(gen, batch, cfg.spatial)
    if _intensity_on(cfg.intensity):
        draws.intensity = draw_intensity_params(gen, batch, data.shape[-1], cfg.intensity)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        if bool(draws.intensity["noise_on"].any()):
            noise_gen = torch.Generator(device=data.device).manual_seed(seed)
            draws.noise = torch.randn((batch, *cfg.spatial.patch_size, data.shape[-1]),
                                      generator=noise_gen, device=data.device)
    if cfg.da5 is not None:
        from anatomask_torch.data.augment_da5 import draw_da5
        draws.da5 = draw_da5(gen, batch, data.shape[-1], cfg.spatial.patch_size, cfg.da5,
                             cfg.intensity)
    return draws


def take_rows(draws: AugmentDraws, rows: torch.Tensor) -> AugmentDraws:
    """The draws of the samples `rows` of a batch's draws: a rank's rows of
    the global batch's draws, as JAX's one key augments the sharded batch.
    DA5's per-batch choices are the batch's; its rectangles are (n, B, 3)."""
    def pick(t, dim=0):
        return t.index_select(dim, rows.to(t.device))

    da5 = None
    if draws.da5 is not None:
        da5 = {k: (pick(v, 1 if k in ("rect_start", "rect_width") else 0)
                   if isinstance(v, torch.Tensor) else v) for k, v in draws.da5.items()}
    return AugmentDraws(
        pick(draws.A), pick(draws.ident), pick(draws.mirror),
        elastic=None if draws.elastic is None else tuple(pick(t) for t in draws.elastic),
        intensity=(None if draws.intensity is None
                   else {k: pick(v) for k, v in draws.intensity.items()}),
        noise=None if draws.noise is None else pick(draws.noise), da5=da5)


def _targets(data: torch.Tensor, seg: torch.Tensor, cfg: "AugmentConfig"):
    """RemoveLabel (-1 -> 0), the cascade one-hot of seg channel 1 appended to
    the data, and the deep-supervision pyramid."""
    seg = torch.where(seg == -1, torch.zeros_like(seg), seg)
    if cfg.cascade_foreground_labels and seg.shape[-1] > 1:
        prev = seg[..., 1]
        onehot = torch.stack([(prev == lab).to(data.dtype)
                              for lab in cfg.cascade_foreground_labels], -1)
        data = torch.cat([data, onehot], dim=-1)
        seg = seg[..., :1]
    return data, (downsample_seg_for_ds(seg, cfg.ds_scales) if cfg.ds_scales else [seg])


def apply_train_augment(cfg: "AugmentConfig", draws: AugmentDraws, data: torch.Tensor,
                        seg: Optional[torch.Tensor] = None):
    """The training transforms with the given draws: data (B, ix, iy, iz, C),
    seg (B, ix, iy, iz, S) int or None -> (data (B, *patch, C) fp32, the seg
    targets a deep-supervision level (B, *, S) int16, or None without seg)."""
    disp = None
    if draws.elastic is not None:
        disp = elastic_displacement(*draws.elastic, cfg.spatial.patch_size, data.device)
    warped = spatial_augment(data.float(), draws.A, draws.ident, cfg.spatial, seg, disp)
    data, seg = (warped, None) if seg is None else warped
    if draws.intensity is not None:
        data = apply_intensity(data, draws.intensity, draws.noise, cfg.intensity,
                               da5=cfg.da5 is not None)
    if cfg.da5 is not None:
        from anatomask_torch.data.augment_da5 import apply_da5_extras
        data, seg = apply_da5_extras(draws.da5, data, seg, cfg.spatial.patch_size)
    if cfg.mirror_axes:
        data = mirror(data, draws.mirror, cfg.mirror_axes)
        if seg is not None:
            seg = mirror(seg, draws.mirror, cfg.mirror_axes)
    if seg is None:
        return data, None
    if cfg.mask_channels_for_norm:
        outside = seg[..., 0] < 0
        for ch in cfg.mask_channels_for_norm:
            data[..., ch] = torch.where(outside, 0.0, data[..., ch])
    return _targets(data, seg, cfg)


def make_train_augment_fn(cfg: AugmentConfig):
    """Returns fn(generator, data (B, ix, iy, iz, C), seg=None, rows=None,
    global_batch=None) -> (data (B, *patch, C) fp32, seg targets or None):
    `draw_all`, then `apply_train_augment`. The draws come from `generator`
    (a CPU torch.Generator); the work runs on data's device. With `rows`,
    data is those rows of a global batch of `global_batch` samples: the
    draws are the global batch's, and data takes its rows' (`take_rows`)."""
    def augment(gen: torch.Generator, data: torch.Tensor, seg=None, rows=None,
                global_batch=None):
        if rows is None:
            return apply_train_augment(cfg, draw_all(gen, data, cfg), data, seg)
        draws = take_rows(draw_all(gen, data, cfg, global_batch), rows)
        return apply_train_augment(cfg, draws, data, seg)

    return augment


def make_val_transform_fn(cfg: AugmentConfig):
    """Validation: fp32 data, RemoveLabel, the cascade one-hot and the
    deep-supervision pyramid; fn(generator, data, seg) as the training one's
    (the generator is unused)."""
    def transform(gen, data: torch.Tensor, seg: torch.Tensor):
        return _targets(data.float(), seg, cfg)

    return transform

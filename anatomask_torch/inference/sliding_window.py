"""Gaussian-weighted sliding-window prediction on the card. Counterpart of
anatomask_tpu/inference/sliding_window.py (`is_oom_error`,
`compute_steps_for_sliding_window`, `pad_nd_image`, `make_tile_predictor`,
`sliding_window_predict`, `sliding_window_predict_device_resident`).

Same tile placement, Gaussian and normalization as there:
- mirror TTA is one forward: the 2^|axes| flips are stacked on the batch
  axis, predicted together, flipped back and averaged in fp32;
- tiles go in batches of `tile_batch_size`; a last batch with fewer tiles is
  padded with duplicates of its last tile, which add nothing to the blend.
  The network always sees full batches, so a `BatchNorm` net, which
  normalises with the statistics of the batch it is given, sees what the
  JAX package's does;
- the Gaussian accumulation runs in place into (X, Y, Z, K) fp32 logits and
  (X, Y, Z) weights; only the final logits go to the host;
- `sliding_window_predict_device_resident` copies the padded volume to the
  device once and slices every tile there; `sliding_window_predict` streams:
  it cuts the tiles on the host and copies each batch over. Where the
  device runs out of memory (`is_oom_error`) during its device
  accumulation, it starts again with the accumulators in host memory.

Both take numpy (c, x, y, z) float32 and return numpy (K, x, y, z) float32.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anatomask_torch.device import resolve_device
from anatomask_torch.inference.gaussian import compute_gaussian
from anatomask_torch.utils.tracing import span


# what a CUDA, cuBLAS or cuDNN allocation failure says in a RuntimeError
_ALLOCATION_FAILURES = ("CUDA out of memory", "CUDA error: out of memory",
                        "CUBLAS_STATUS_ALLOC_FAILED", "CUDNN_STATUS_ALLOC_FAILED")


def is_oom_error(e: BaseException) -> bool:
    """True when the exception says that device memory ran out: a
    torch.cuda.OutOfMemoryError, or a RuntimeError of a CUDA, cuBLAS or
    cuDNN allocation. Anything else (a host MemoryError, a ValueError that
    mentions memory, a failed kernel launch) is an error to surface."""
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    return type(e) is RuntimeError and any(s in str(e) for s in _ALLOCATION_FAILURES)


def compute_steps_for_sliding_window(image_size: Sequence[int], tile_size: Sequence[int],
                                     tile_step_size: float) -> List[List[int]]:
    """Evenly spaced tile origins covering [0, image - tile] inclusive; step at
    most tile * tile_step_size."""
    if any(i < t for i, t in zip(image_size, tile_size)):
        raise ValueError(f"image size {tuple(image_size)} must be >= tile size "
                         f"{tuple(tile_size)} (pad first)")
    if not 0 < tile_step_size <= 1:
        raise ValueError(f"tile_step_size must be in (0, 1], got {tile_step_size}")
    target = [t * tile_step_size for t in tile_size]
    num_steps = [int(np.ceil((i - t) / j)) + 1 for i, j, t in zip(image_size, target, tile_size)]
    steps = []
    for dim in range(len(tile_size)):
        max_start = image_size[dim] - tile_size[dim]
        actual = max_start / (num_steps[dim] - 1) if num_steps[dim] > 1 else 1e9
        steps.append([int(np.round(actual * i)) for i in range(num_steps[dim])])
    return steps


def pad_nd_image(data: np.ndarray, new_shape: Sequence[int]
                 ) -> Tuple[np.ndarray, Tuple[slice, ...]]:
    """Symmetrically zero-pad the trailing dims of `data` to at least
    `new_shape`. Returns (padded, slicer that undoes the padding)."""
    old_shape = data.shape
    n_lead = len(old_shape) - len(new_shape)
    target = list(old_shape[:n_lead]) + [max(o, n) for o, n in
                                         zip(old_shape[n_lead:], new_shape)]
    pads = [((t - o) // 2, (t - o) - (t - o) // 2) for o, t in zip(old_shape, target)]
    padded = np.pad(data, pads)
    slicer = tuple(slice(lo, lo + o) for (lo, _), o in zip(pads, old_shape))
    return padded, slicer


def make_tile_predictor(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                        mirror_axes: Optional[Sequence[int]] = None
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap a network apply (B, x, y, z, C_in) -> (B, x, y, z, C_out) into a
    mirror-TTA tile function returning fp32. The flips are stacked on the
    batch axis, so the whole TTA is one forward. mirror_axes are spatial axis
    indices (0..2)."""
    flip_combos: List[Tuple[int, ...]] = [()]
    if mirror_axes:
        flip_combos = [tuple(a + 1 for a in combo)  # +1: skip the batch axis
                       for r in range(len(mirror_axes) + 1)
                       for combo in itertools.combinations(mirror_axes, r)]

    def tile_fn(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if len(flip_combos) > 1:
            with span("predict.tiles"):
                x = torch.cat([torch.flip(x, axes) if axes else x for axes in flip_combos])
        with span("predict.forward"):
            out = apply_fn(x)
        with span("predict.merge"):
            if len(flip_combos) == 1:
                return out.float()
            total = None
            for i, axes in enumerate(flip_combos):
                part = out[i * b:(i + 1) * b].float()
                part = torch.flip(part, axes) if axes else part
                total = part if total is None else total + part
            return total / len(flip_combos)

    return tile_fn


def _tile_slices(origin, tile_size) -> Tuple[slice, ...]:
    return tuple(slice(o, o + t) for o, t in zip(origin, tile_size))


@torch.no_grad()
def _predict(get_tiles: Callable, spatial: Sequence[int], slicer_to_undo, tile_fn: Callable,
             tile_size: Tuple[int, ...], num_output_channels: int, tile_step_size: float,
             use_gaussian: bool, tile_batch_size: int, acc_device: torch.device) -> np.ndarray:
    """Predict every tile in full batches (the last one padded with its last
    tile), Gaussian-accumulate the real tiles in place on `acc_device`,
    normalize, and return the un-padded (K, x, y, z) logits on the host."""
    origins = list(itertools.product(*compute_steps_for_sliding_window(spatial, tile_size,
                                                                       tile_step_size)))
    with span("predict.upload"):
        gauss = (compute_gaussian(tile_size, value_scaling_factor=1000.0) if use_gaussian
                 else np.ones(tile_size, dtype=np.float32))
        gauss = torch.tensor(gauss, device=acc_device)
        logits = torch.zeros((*spatial, num_output_channels), dtype=torch.float32,
                             device=acc_device)
        weights = torch.zeros(tuple(spatial), dtype=torch.float32, device=acc_device)
    for start in range(0, len(origins), tile_batch_size):
        batch = origins[start:start + tile_batch_size]
        n_valid = len(batch)
        batch += [batch[-1]] * (tile_batch_size - n_valid)
        with span("predict.tiles"):
            tiles = get_tiles(batch)
        preds = tile_fn(tiles)
        with span("predict.merge"):
            preds = preds[:n_valid].to(acc_device)  # (b, tx, ty, tz, K) fp32
            for pred, origin in zip(preds, batch):
                sl = _tile_slices(origin, tile_size)
                logits[sl].addcmul_(pred, gauss[..., None])
                weights[sl].add_(gauss)
    with span("predict.download"):
        logits.div_(weights[..., None])
        out = np.moveaxis(logits.cpu().numpy(), -1, 0)
        return out[(slice(None), *slicer_to_undo[1:])]


def sliding_window_predict_device_resident(
        data: np.ndarray, tile_fn: Callable, tile_size: Sequence[int],
        num_output_channels: int, tile_step_size: float = 0.5, use_gaussian: bool = True,
        tile_batch_size: int = 4, device="cuda") -> np.ndarray:
    """Whole-volume device-resident sliding window: the data crosses to the
    device once and the logits come back once. data (c, x, y, z) float32 ->
    (num_output_channels, x, y, z) float32. `tile_fn` (B, tx, ty, tz, c) ->
    (B, tx, ty, tz, K), already TTA-wrapped where wanted."""
    if data.ndim != 4:
        raise ValueError(f"expected (c, x, y, z) data, got shape {data.shape}")
    device = resolve_device(device)
    tile_size = tuple(int(t) for t in tile_size)
    with span("predict.upload"):
        data_padded, slicer_to_undo = pad_nd_image(data, tile_size)
        vol = torch.tensor(np.moveaxis(data_padded, 0, -1), dtype=torch.float32, device=device)

    def get_tiles(batch):
        return torch.stack([vol[_tile_slices(o, tile_size)] for o in batch])

    return _predict(get_tiles, data_padded.shape[1:], slicer_to_undo, tile_fn, tile_size,
                    num_output_channels, tile_step_size, use_gaussian, tile_batch_size, device)


def sliding_window_predict(
        data: np.ndarray, tile_fn: Callable, tile_size: Sequence[int],
        num_output_channels: int, tile_step_size: float = 0.5, use_gaussian: bool = True,
        tile_batch_size: int = 4, device="cuda", verbose: bool = False) -> np.ndarray:
    """Streaming sliding window: the volume stays on the host and each batch
    of tiles is copied to the device. The accumulation runs on the device,
    or, where the device runs out of memory (is_oom_error), again from the
    start in host memory. Same arguments and result as
    sliding_window_predict_device_resident."""
    if data.ndim != 4:
        raise ValueError(f"expected (c, x, y, z) data, got shape {data.shape}")
    device = resolve_device(device)
    tile_size = tuple(int(t) for t in tile_size)
    with span("predict.upload"):
        data_padded, slicer_to_undo = pad_nd_image(data, tile_size)
    spatial = data_padded.shape[1:]
    if verbose:
        n = math.prod(len(s) for s in compute_steps_for_sliding_window(spatial, tile_size,
                                                                         tile_step_size))
        print(f"sliding window: {n} tiles over {spatial}")

    def get_tiles(batch):
        tiles = np.stack([data_padded[(slice(None), *_tile_slices(o, tile_size))]
                          for o in batch])
        return torch.tensor(np.moveaxis(tiles, 1, -1), dtype=torch.float32, device=device)

    def run(acc_device):
        return _predict(get_tiles, spatial, slicer_to_undo, tile_fn, tile_size,
                        num_output_channels, tile_step_size, use_gaussian, tile_batch_size,
                        acc_device)

    try:
        return run(device)
    except RuntimeError as e:
        if not is_oom_error(e):
            raise
    # the failed attempt's tensors went with its traceback: free their memory
    torch.cuda.empty_cache()
    if verbose:
        print("device accumulation out of memory; accumulating in host memory")
    return run(torch.device("cpu"))

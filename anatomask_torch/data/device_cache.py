"""GPU-resident case cache: device-side patch extraction for pretraining and
supervised training. Counterpart of anatomask_tpu/data/device_cache.py.

- A window of preprocessed cases lives on the device as ONE (S, X, Y, Z, C)
  tensor (bf16), each slot holding a case (or a random window of a large
  case) zero-padded into a uniform slot shape with an `initial_patch`-sized
  margin, so every sampler bbox (including the negative / beyond-extent
  origins that the host sampler realises by zero-padding) maps to an
  in-bounds slot origin.
- Per step the HOST draws only (slot, origin) pairs with numpy, by the
  sampler's bbox and oversampling formulas against the slot geometry; the
  patches are sliced out of the cache on the device (`extract`).
- With `include_seg` (supervised training) the seg channels are stacked after
  the data channels of the same slot tensor, the margin outside the case
  filled with -1 (the sampler's seg pad) where the data pads with 0; `extract_split` splits them off as int16. Labels live in the cache
  dtype: bf16 holds integers exactly only up to 256, which the trainer
  checks.
- Slots refill in the background: a host thread prepares the next case and
  copies it to the device; the train loop applies at most one staged slot
  between steps, in place (JAX donates the cache and writes a new array; here
  the slot of the one tensor is overwritten).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anatomask_torch.data.dataset import CaseDataset

MAX_CLASS_LOCS = 5000  # foreground voxels kept a class and slot for oversampling
SEG_FILL = -1.0        # seg outside the case, as the sampler pads it


class _SlotMeta:
    __slots__ = ("key", "offset", "extent", "class_locations")

    def __init__(self, key, offset, extent, class_locations):
        self.key = key
        self.offset = np.asarray(offset, int)    # case-window origin in slot
        self.extent = np.asarray(extent, int)    # case-window size
        self.class_locations = class_locations   # {cls: (n, 3) slot coords}


def extract_patches(cache: torch.Tensor, slots: np.ndarray, origins: np.ndarray,
                    patch: Sequence[int]) -> torch.Tensor:
    """cache (S, X, Y, Z, C); slots (B,) and origins (B, 3) host integers,
    every patch in bounds -> (B, *patch, C) on the cache's device: one slice
    a sample (the host already holds the origins), stacked in one copy."""
    px, py, pz = (int(v) for v in patch)
    return torch.stack([cache[int(s), x:x + px, y:y + py, z:z + pz]
                        for s, (x, y, z) in zip(slots, np.asarray(origins, int).tolist())])


class DeviceCaseCache:
    """See module docstring. Use `sample_batch()` + `extract()` per step and
    `maybe_refill()` between steps."""

    def __init__(
        self,
        dataset: CaseDataset,
        initial_patch: Sequence[int],        # sampled (enlarged) patch
        final_patch: Sequence[int],          # network patch
        capacity_mb: int = 1024,
        oversample_foreground_percent: float = 0.33,
        annotated_classes_key: Optional[tuple] = None,
        has_ignore: bool = False,
        batch_size: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        seed: Optional[int] = None,
        whole_dataset_mode: bool = False,
        device="cuda",
        probabilistic_oversampling: bool = False,
        include_seg: bool = False,
    ):
        self.dataset = dataset
        self.keys = sorted(dataset.keys())
        self.initial_patch = np.asarray(initial_patch, int)
        self.final_patch = np.asarray(final_patch, int)
        self.batch_size = batch_size
        self.oversample_foreground_percent = oversample_foreground_percent
        self.probabilistic_oversampling = probabilistic_oversampling
        self.annotated_classes_key = annotated_classes_key
        self.has_ignore = has_ignore
        self.rng = np.random.RandomState(seed)
        # the refill thread draws windows and class-location subsamples while
        # the train thread draws batches; RandomState is not thread-safe, so
        # slot preparation has its own stream
        self.refill_rng = np.random.RandomState(None if seed is None else seed + 9173)
        self.dtype = dtype
        self.device = torch.device(device)
        self.include_seg = include_seg

        # survey every case's shape from the npy/npz headers only
        shapes = [tuple(dataset.case_shape(k)) for k in self.keys]
        self.num_data_channels = shapes[0][0]
        # seg channels from one (memory-mapped) load
        self.num_seg_channels = (dataset.load_case(self.keys[0])[1].shape[0]
                                 if include_seg else 0)
        self.num_channels = self.num_data_channels + self.num_seg_channels
        max_shape = np.max(np.asarray([s[1:] for s in shapes], int), axis=0)
        # a slot holds at most twice the initial patch of a case
        self.window = np.minimum(max_shape, self.initial_patch * 2)
        self.slot_shape = tuple(int(v) for v in (self.window + self.initial_patch))

        bytes_per_slot = (int(np.prod(self.slot_shape)) * self.num_channels
                          * torch.empty((), dtype=dtype).element_size())
        budget_slots = (capacity_mb * 2 ** 20) // bytes_per_slot
        if budget_slots < 2:
            print(f"[device-cache] WARNING: slot size "
                  f"{bytes_per_slot / 2**20:.0f} MB x 2 exceeds the "
                  f"{capacity_mb} MB budget; allocating 2 slots anyway "
                  f"({2 * bytes_per_slot / 2**20:.0f} MB of device memory) - raise "
                  f"device_cache_mb", flush=True)
        # whole-dataset residency: every case fits its window untruncated and
        # the budget holds one slot per case -> one slot per case, uniform case
        # sampling, refills redundant
        self.covers_whole_cases = bool(np.all(self.window >= max_shape))
        if (whole_dataset_mode and self.covers_whole_cases
                and budget_slots >= len(self.keys)):
            self.num_slots = max(2, len(self.keys))
            self.whole_dataset_resident = True
        else:
            self.num_slots = max(2, min(len(self.keys) * 4, budget_slots))
            self.whole_dataset_resident = False
        self.meta: List[Optional[_SlotMeta]] = [None] * self.num_slots
        self._key_cursor = 0
        self._refill_queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._refill_thread = None
        self._stop = threading.Event()

        # filled slot by slot: the host holds one slot at a time
        self.cache = torch.empty((self.num_slots, *self.slot_shape, self.num_channels),
                                 dtype=dtype, device=self.device)
        for s in range(self.num_slots):
            arr, meta = self._prepare_slot_host()
            self.cache[s] = torch.from_numpy(arr).to(self.device, dtype)
            self.meta[s] = meta
        self._refill_cursor = 0
        self.slots_refilled = 0  # staged slots applied by maybe_refill so far

    # --- host-side slot preparation ------------------------------------------
    def _next_key(self) -> str:
        if self._key_cursor == 0:
            self._order = self.refill_rng.permutation(len(self.keys))
        k = self.keys[int(self._order[self._key_cursor])]
        self._key_cursor = (self._key_cursor + 1) % len(self.keys)
        return k

    def _prepare_slot_host(self) -> Tuple[np.ndarray, _SlotMeta]:
        key = self._next_key()
        data, seg, props = self.dataset.load_case(key)
        case_shape = np.asarray(data.shape[1:], int)
        win = np.minimum(case_shape, self.window)
        # random window for oversized cases (re-randomised each refill)
        lo = np.array([self.refill_rng.randint(0, c - w + 1) if c > w else 0
                       for c, w in zip(case_shape, win)])
        offset = ((np.asarray(self.slot_shape) - win) // 2).astype(int)
        slot = np.zeros((*self.slot_shape, self.num_channels), np.float32)
        slot[..., self.num_data_channels:] = SEG_FILL
        sl_src = tuple(slice(int(l), int(l + w)) for l, w in zip(lo, win))
        sl_dst = tuple(slice(int(o), int(o + w)) for o, w in zip(offset, win))
        nd = self.num_data_channels
        slot[sl_dst + (slice(0, nd),)] = np.moveaxis(np.asarray(data[(slice(None), *sl_src)]),
                                                     0, -1)
        if self.include_seg:
            slot[sl_dst + (slice(nd, None),)] = np.moveaxis(
                np.asarray(seg[(slice(None), *sl_src)]), 0, -1)

        # translate class_locations into slot coordinates, window-filtered
        cls_locs: Dict = {}
        raw = (props or {}).get("class_locations") or {}
        for cls, locs in raw.items():
            locs = np.asarray(locs)
            if locs.size == 0:
                continue
            coords = locs[:, -3:]  # (sample?, x, y, z) -> spatial tail
            keep = np.all((coords >= lo) & (coords < lo + win), axis=1)
            coords = coords[keep] - lo + offset
            if len(coords) > MAX_CLASS_LOCS:
                coords = coords[self.refill_rng.choice(len(coords), MAX_CLASS_LOCS,
                                                       replace=False)]
            if len(coords):
                cls_locs[cls] = coords
        return slot, _SlotMeta(key, offset, win, cls_locs)

    # --- sampling -------------------------------------------------------------
    def _do_oversample(self, i: int) -> bool:
        if self.probabilistic_oversampling:
            return bool(self.rng.uniform() < self.oversample_foreground_percent)
        return not i < round(self.batch_size * (1 - self.oversample_foreground_percent))

    def _bbox_for_slot(self, meta: _SlotMeta, force_fg: bool) -> np.ndarray:
        """The sampler's get_bbox formulas against the slot geometry; slot
        margins make every origin in-bounds."""
        patch = self.initial_patch
        extent = meta.extent
        need = np.maximum(patch - self.final_patch, 0)
        need = np.where(need + extent < patch, patch - extent, need)
        lbs = meta.offset - need // 2
        ubs = meta.offset + extent + need // 2 + need % 2 - patch
        ubs = np.maximum(ubs, lbs)
        if force_fg and meta.class_locations:
            classes = [c for c in meta.class_locations
                       if not (self.has_ignore and c == self.annotated_classes_key)]
            if classes:
                cls = classes[int(self.rng.randint(len(classes)))]
                locs = meta.class_locations[cls]
                voxel = locs[int(self.rng.randint(len(locs)))]
                lo = np.maximum(lbs, voxel - patch // 2)
                return np.minimum(lo, ubs).astype(np.int32)
        return np.array([self.rng.randint(l, u + 1) for l, u in zip(lbs, ubs)], np.int32)

    def sample_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (slots (B,) int32, origins (B, 3) int32)."""
        slots = self.rng.randint(0, self.num_slots, self.batch_size).astype(np.int32)
        origins = np.stack([
            self._bbox_for_slot(self.meta[int(s)], self._do_oversample(i))
            for i, s in enumerate(slots)
        ])
        return slots, origins.astype(np.int32)

    def sample_chunk(self, n_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """`n_steps` consecutive batches (the same RNG stream as n_steps
        sample_batch calls) -> (slots (K, B) int32, origins (K, B, 3) int32)."""
        draws = [self.sample_batch() for _ in range(n_steps)]
        return np.stack([d[0] for d in draws]), np.stack([d[1] for d in draws])

    def extract(self, slots: np.ndarray, origins: np.ndarray) -> torch.Tensor:
        """Device-side gather -> (B, *initial_patch, C) in the cache dtype."""
        return extract_patches(self.cache, slots, origins, self.initial_patch)

    def extract_split(self, slots: np.ndarray,
                      origins: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """With include_seg: (data (B, *initial_patch, C) in the cache dtype,
        seg (B, *initial_patch, S) int16)."""
        pat = self.extract(slots, origins)
        return pat[..., :self.num_data_channels], pat[..., self.num_data_channels:].to(torch.int16)

    # --- background refill ----------------------------------------------------
    def start_refill(self, steps_per_slot: Optional[int] = None):
        """Begin background refills, at most one slot replacement every
        `steps_per_slot` `maybe_refill` steps (default 4). A slot is tens of
        MB of host-to-device copy, so refills stay rare relative to steps."""
        if self._refill_thread is not None:
            return
        self._refill_every = max(1, int(steps_per_slot if steps_per_slot is not None else 4))
        self._steps_since_refill = 0
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

        def worker():
            while not self._stop.is_set():
                try:
                    arr, meta = self._prepare_slot_host()
                    # cast on the host first (bf16 halves the bytes), copy on
                    # this thread's stream so that it overlaps the train steps
                    host = torch.from_numpy(arr).to(self.dtype)
                    if stream is None:
                        item = (host, None, meta)
                    else:
                        with torch.cuda.stream(stream):
                            dev = host.pin_memory().to(self.device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(stream)
                        item = (dev, event, meta)
                except Exception as e:
                    self._refill_queue.put(e)
                    return
                while not self._stop.is_set():
                    try:
                        self._refill_queue.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue

        self._refill_thread = threading.Thread(target=worker, daemon=True)
        self._refill_thread.start()

    def maybe_refill(self, steps: int = 1) -> int:
        """Apply staged slot refills, at most one per `steps_per_slot` train
        steps (non-blocking). `steps` is how many train steps the caller ran
        since the last call. Accrued credit is capped at the staging-queue
        depth so that a long stall is not followed by an unthrottled burst.
        The slot is overwritten in place. Returns the number of slots
        replaced."""
        every = getattr(self, "_refill_every", 1)
        self._steps_since_refill = min(getattr(self, "_steps_since_refill", 0) + steps,
                                       self._refill_queue.maxsize * every)
        applied = 0
        while self._steps_since_refill >= every:
            try:
                item = self._refill_queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, Exception):
                raise RuntimeError("device-cache refill worker died") from item
            dev, event, meta = item
            self._steps_since_refill -= every
            idx = self._refill_cursor
            self._refill_cursor = (self._refill_cursor + 1) % self.num_slots
            if event is not None:
                torch.cuda.current_stream(self.device).wait_event(event)
                dev.record_stream(torch.cuda.current_stream(self.device))
            self.cache[idx].copy_(dev)
            self.meta[idx] = meta
            applied += 1
        self.slots_refilled += applied
        return applied

    def stop(self):
        self._stop.set()
        try:
            while True:
                self._refill_queue.get_nowait()
        except queue.Empty:
            pass
        if self._refill_thread is not None:
            self._refill_thread.join(timeout=10)

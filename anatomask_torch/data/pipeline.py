"""Host->device input pipeline. Counterpart of anatomask_tpu/data/pipeline.py.

Host threads only gather memory-mapped patches (the augmentation runs on the
device); batches are staged ahead of consumption so that the device does not
wait on the host. The device step is a pinned-memory copy with
`non_blocking=True` on a side stream of the worker thread; the consumer's
stream waits on it before it reads the batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


def _to_torch(v: np.ndarray, dtype: Optional[torch.dtype]) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(v))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


class PrefetchPipeline:
    """Pulls batches from `sampler.generate_batch()` on background threads and
    stages them ahead of consumption. Nondeterministic batch order across
    workers; per-sampler RNG keeps contents reproducible with num_workers=1.

    `device`: where the arrays go (None: stay host torch tensors).
    `transfer_dtype`: cast of the float arrays before the copy (bf16 halves
    the bytes; the augmentation widens to fp32 for interpolation).
    `drop_keys`: batch entries never transferred (pretraining drops "seg": the
    sampler needs labels only for foreground oversampling)."""

    def __init__(self, sampler, num_workers: int = 3, prefetch_depth: int = 4,
                 device=None, transfer_dtype: Optional[torch.dtype] = None,
                 drop_keys: tuple = ()):
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.queue: "queue.Queue" = queue.Queue(maxsize=prefetch_depth)
        self.device = None if device is None else torch.device(device)
        self.drop_keys = tuple(drop_keys)
        self.transfer_dtype = transfer_dtype
        self._stop = threading.Event()
        self._threads = []
        self._started = False

    def _clone_sampler(self, worker_id: int):
        """Per-worker sampler copy with an independent RNG stream so workers
        sample in parallel (numpy RandomState is not thread-safe; with a single
        worker the original sampler is used, keeping runs reproducible)."""
        if self.num_workers == 1:
            return self.sampler
        import copy
        clone = copy.copy(self.sampler)
        base_seed = self.sampler.rng.randint(0, 2 ** 31 - 1)
        clone.rng = np.random.RandomState(base_seed + worker_id)
        return clone

    def _transfer(self, arrays: dict, stream) -> dict:
        out = {k: _to_torch(v, self.transfer_dtype) for k, v in arrays.items()}
        if self.device is None or self.device.type == "cpu":
            return out
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True) for k, v in out.items()}
        event = torch.cuda.Event()
        event.record(stream)
        return {"__event__": event, **out}

    def _worker(self, worker_id: int = 0):
        sampler = self._clone_sampler(worker_id)
        stream = (torch.cuda.Stream(self.device)
                  if self.device is not None and self.device.type == "cuda" else None)
        while not self._stop.is_set():
            try:
                batch = sampler.generate_batch()
                arrays = self._transfer({k: v for k, v in batch.items()
                                         if isinstance(v, np.ndarray)
                                         and k not in self.drop_keys}, stream)
            except Exception as e:  # surface worker death to the consumer
                self.queue.put(e)
                return
            while not self._stop.is_set():
                try:
                    self.queue.put(arrays, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._started:
            return
        self._started = True
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, args=(w,), daemon=True)
            t.start()
            self._threads.append(t)

    def __iter__(self) -> Iterator[dict]:
        self.start()
        return self

    def __next__(self) -> dict:
        item = self.queue.get()
        if isinstance(item, Exception):
            raise RuntimeError("data pipeline worker died") from item
        event = item.pop("__event__", None)
        if event is not None:  # the copy ran on the worker's stream
            torch.cuda.current_stream(self.device).wait_event(event)
            for v in item.values():
                v.record_stream(torch.cuda.current_stream(self.device))
        return item

    def stop(self):
        self._stop.set()
        # drain so workers blocked on put can exit
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=10)

"""Data parallelism for both trainers: one process a card, joined by a
torch.distributed process group (NCCL on CUDA, gloo on the CPU).
Counterpart of anatomask_tpu/parallel/mesh.py and of the JAX trainer's
`pick_mesh_for_batch`.

JAX runs one SPMD program over Mesh(('data',)): the batch is sharded, and
every statistic the step reduces over the batch is global for free. Here
each rank runs the step on its rows of the global batch, and each such
statistic is summed across ranks with `all_reduce_sum`, whose backward is the
same sum. A rank's loss is its share of the global loss (the mean over ranks
is JAX's loss), so the mean over ranks of the ranks' gradients, one
all-reduce after the microbatches (`all_reduce_mean_`), is JAX's gradient.

Without a process group (world 1) every helper is the identity and no
collective runs. With a group, whatever its size, the collectives run.

The launcher follows the reference nnU-Net's run_training.py:108-142:
`torch.multiprocessing.spawn`, `init_process_group`, the card set per rank,
`destroy_process_group`. A rank's exception fails the parent.
"""
from __future__ import annotations

import os
import socket
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def compute_shard_batch_and_oversample(
    global_batch_size: int,
    oversample_foreground_percent: float,
    shard_rank: int,
    num_shards: int,
) -> Tuple[int, float]:
    """Returns (shard_batch_size, shard_oversample_percent).

    Semantics (reference nnUNetTrainer._set_batch_size_and_oversample): sample
    index s in the GLOBAL batch is forced-foreground iff
    s >= round(B * (1 - p)). Each shard owns a contiguous index range; its
    local oversample fraction is the portion of its range at/after that
    threshold, so the union over shards reproduces the global policy exactly.
    """
    assert global_batch_size >= num_shards, (
        "global batch size must be >= number of shards"
    )
    base = global_batch_size // num_shards
    rem = global_batch_size % num_shards
    sizes = [base + (1 if r < rem else 0) for r in range(num_shards)]
    starts = np.cumsum([0] + sizes[:-1])
    lo = int(starts[shard_rank])
    hi = lo + sizes[shard_rank]

    threshold = round(global_batch_size * (1 - oversample_foreground_percent))
    if hi <= threshold:
        frac = 0.0
    elif lo >= threshold:
        frac = 1.0
    else:
        frac = (hi - threshold) / sizes[shard_rank]
    return sizes[shard_rank], float(frac)


# --- the process group ---------------------------------------------------------

def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def barrier() -> None:
    if distributed():
        dist.barrier()


def world_size_for(device, cap: Optional[int] = None) -> int:
    """The ranks a run takes, as JAX sizes its mesh: every visible CUDA card,
    capped by `cap` (-num_gpus) or ATK_NUM_DEVICES; on the CPU the cap, else
    1. A cap above the visible cards raises: two ranks never share a card."""
    if not cap:
        cap = int(os.environ.get("ATK_NUM_DEVICES", "0")) or None
    if torch.device(device).type != "cuda":
        return cap or 1
    visible = torch.cuda.device_count()
    if cap is not None and cap > visible:
        raise RuntimeError(f"{cap} ranks asked for and {visible} CUDA device(s) visible: "
                           f"one rank a card; pass -device cpu for gloo ranks on the CPU")
    return cap or max(1, visible)


def global_batch_size(batch_size: int, n_shards: int, log=print) -> int:
    """JAX's pick_mesh_for_batch with scale_batch_to_devices: a batch that the
    shard count does not divide is scaled up to its next multiple."""
    if batch_size % n_shards == 0:
        return batch_size
    scaled = -(-batch_size // n_shards) * n_shards
    log(f"[mesh] global batch scaled {batch_size} -> {scaled} to use all {n_shards} ranks "
        f"(the batch does not divide the rank count)")
    return scaled


def shard_batch_spec(global_batch: int, oversample_foreground_percent: float
                     ) -> Tuple[int, float]:
    """(this rank's batch, its oversample fraction), JAX's _host_batch_spec:
    the global batch's at world 1."""
    if world() == 1:
        return global_batch, oversample_foreground_percent
    return compute_shard_batch_and_oversample(global_batch, oversample_foreground_percent,
                                              rank(), world())


def local_rows(global_batch: int, micro: int = 1) -> Optional[torch.Tensor]:
    """The global batch's rows that this rank holds, in its local order: its
    contiguous share of each of the `micro` microbatches (global rows
    [j*mb, (j+1)*mb), JAX's x.reshape(micro, mb, ...)), so that a
    microbatch's batch-pooled statistics pool JAX's rows. None at world 1."""
    w, r = world(), rank()
    if w == 1:
        return None
    mb = global_batch // micro
    share = mb // w
    return torch.tensor([j * mb + r * share + i for j in range(micro) for i in range(share)])


# --- collectives ---------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, differentiable (the backward sums the
    ranks' gradients); x itself without a process group."""
    if not distributed():
        return x
    return _AllReduceSum.apply(x)


@torch.no_grad()
def gather_ranks(x: torch.Tensor) -> torch.Tensor:
    """(world, *x.shape): every rank's x (the same shape on each), in rank
    order, without gradient. An all-reduce of zeros around each rank's slot,
    which every backend takes for CUDA tensors (gloo has no CUDA all_gather)."""
    if not distributed():
        return x[None]
    out = x.new_zeros((world(), *x.shape))
    out[rank()] = x
    dist.all_reduce(out)
    return out


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the ranks, without gradient; x without a group."""
    if not distributed():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x / world()


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     extra: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Each of `tensors` (one dtype) replaced in place by its mean over the
    ranks, in one all-reduce of their concatenation with `extra`; returns
    extra's mean. Without a process group: nothing changes."""
    if not distributed():
        return extra
    rest = [] if extra is None else [extra.reshape(-1).to(tensors[0].dtype)]
    flat = torch.cat([t.reshape(-1) for t in tensors] + rest)
    dist.all_reduce(flat)
    flat /= world()
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return None if extra is None else flat[off:].view_as(extra).to(extra.dtype)


# --- the launcher --------------------------------------------------------------

def rank_device(device) -> torch.device:
    """This rank's device: "cuda" without an index is the rank's own card;
    a device with an index (cuda:0) is every rank's (gloo only), the CPU the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and distributed():
        return torch.device("cuda", rank())
    return device


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank_: int, fn: Callable, world_size: int, backend: str, port: int,
               device: str, args: tuple) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None else rank_)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank_,
                            world_size=world_size)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, device, *args, backend: Optional[str] = None):
    """fn(*args) in `world_size` spawned ranks of one process group on
    localhost (NCCL for CUDA, gloo for the CPU unless `backend` says), each
    on its rank_device(device); returns when all have ended and raises if one
    failed (the others are ended then). fn must be importable by name."""
    device = str(torch.device(device))
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    torch.multiprocessing.spawn(_rank_main, nprocs=world_size, join=True,
                                args=(fn, world_size, backend, _free_port(), device, args))


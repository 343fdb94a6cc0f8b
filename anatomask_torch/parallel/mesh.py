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

Two ways into a group, one per process:
- `launch` follows the reference nnU-Net's run_training.py:108-142 on one
  machine: `torch.multiprocessing.spawn`, `init_process_group`, the card set
  per rank, `destroy_process_group`. A rank's exception fails the parent.
- `run_joined` is the counterpart of the JAX package's multi-host start
  (anatomask_tpu/parallel/mesh.py `maybe_initialize_distributed`): a
  process that PyTorch's launcher (`torchrun`) started on any node joins the
  group its variables describe (the env:// rendezvous) as that one rank, on
  its node's card LOCAL_RANK. Unlike JAX, which carries on in one process
  when its start fails, a partial set of the variables or a failed join
  raises: one node alone would train at the wrong global batch.
"""
from __future__ import annotations

import itertools
import os
import socket
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

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


# what `torchrun` (python -m torch.distributed.run) sets for each process
LAUNCHER_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                      "LOCAL_WORLD_SIZE")


class LauncherEnv(NamedTuple):
    world: int
    rank: int
    local_rank: int
    local_world: int


def launcher_env() -> Optional[LauncherEnv]:
    """This process's place in the launcher's group, from its variables;
    None when none of them is set. A partial or inconsistent set raises."""
    found = {k: os.environ[k] for k in LAUNCHER_VARIABLES if k in os.environ}
    if not found:
        return None
    missing = [k for k in LAUNCHER_VARIABLES if k not in found]
    if missing:
        raise RuntimeError(f"launcher variables {sorted(found)} set without {missing}: start "
                           f"each process with torchrun, or set none of {LAUNCHER_VARIABLES}")
    try:
        env = LauncherEnv(*(int(found[k]) for k in LAUNCHER_VARIABLES[2:]))
    except ValueError as e:
        raise RuntimeError(f"launcher variables {found}: {e}") from None
    if not (0 <= env.rank < env.world and 0 <= env.local_rank < env.local_world <= env.world):
        raise RuntimeError(f"inconsistent launcher variables: RANK {env.rank} of WORLD_SIZE "
                           f"{env.world}, LOCAL_RANK {env.local_rank} of LOCAL_WORLD_SIZE "
                           f"{env.local_world}")
    return env


def world_size_for(device, cap: Optional[int] = None) -> int:
    """The ranks a run takes, as JAX sizes its mesh: under the launcher its
    WORLD_SIZE, else every visible CUDA card, capped by `cap` (-num_gpus) or
    ATK_NUM_DEVICES; on the CPU the cap, else 1. A cap that is not the
    launcher's WORLD_SIZE raises (JAX's cap counts the global mesh), as do a
    cap above the visible cards and, under the launcher with "cuda", more
    ranks on a node than it has cards: two ranks never share a card unless
    the device names one (cuda:0)."""
    if not cap:
        cap = int(os.environ.get("ATK_NUM_DEVICES", "0")) or None
    device = torch.device(device)
    env = launcher_env()
    if env is not None:
        if cap is not None and cap != env.world:
            raise RuntimeError(f"{cap} ranks asked for (-num_gpus or ATK_NUM_DEVICES) and the "
                               f"launcher's WORLD_SIZE is {env.world}")
        visible = torch.cuda.device_count()
        if device.type == "cuda" and device.index is None and env.local_world > visible:
            raise RuntimeError(f"LOCAL_WORLD_SIZE {env.local_world} ranks on this node and "
                               f"{visible} CUDA device(s) visible: one rank a card")
        return env.world
    if device.type != "cuda":
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


# --- the launchers -------------------------------------------------------------

def rank_device(device) -> torch.device:
    """This rank's device: "cuda" without an index is the rank's own card on
    its node (LOCAL_RANK under the launcher, the rank under `launch`); a
    device with an index (cuda:0) is every rank's (gloo), the CPU the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and distributed():
        env = launcher_env()
        return torch.device("cuda", env.local_rank if env is not None else rank())
    return device


def backend_for(device) -> str:
    """NCCL when each rank has its own card ("cuda"), else gloo: on the CPU,
    and where every rank of a node shares the card that the device names."""
    device = torch.device(device)
    return "nccl" if device.type == "cuda" and device.index is None else "gloo"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _in_group(fn: Callable, args: tuple, device, local_rank: int, backend: str,
              **init) -> None:
    """fn(*args) in the process group that init_process_group(backend, **init)
    joins, on this process's card; the group is left whatever fn does."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None else local_rank)
    dist.init_process_group(backend, **init)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank_: int, fn: Callable, world_size: int, backend: str, port: int,
               device: str, args: tuple) -> None:
    _in_group(fn, args, device, rank_, backend, init_method=f"tcp://localhost:{port}",
              rank=rank_, world_size=world_size)


def launch(fn: Callable, world_size: int, device, *args):
    """fn(*args) in `world_size` spawned ranks of one process group on
    localhost (backend_for(device)), each on its rank_device(device); returns
    when all have ended and raises if one failed (the others are ended then).
    fn must be importable by name."""
    device = str(torch.device(device))
    torch.multiprocessing.spawn(_rank_main, nprocs=world_size, join=True,
                                args=(fn, world_size, backend_for(device), _free_port(),
                                      device, args))


# this process's joins so far: each join keys its rendezvous apart in the
# launcher's store (a group left and joined again under the same keys would
# read the first group's addresses)
_JOINS = itertools.count()


def run_joined(fn: Callable, device, *args) -> None:
    """fn(*args) in this process as its rank of the group that the
    launcher's variables describe (the "env://" rendezvous, backend_for(device),
    the node's card LOCAL_RANK for "cuda"), then the group is left. Never
    spawns. Every rank must make the same sequence of joins. Raises without
    the variables, on a partial set, and when the join fails: no fallback to
    another backend or to one process."""
    env = launcher_env()
    if env is None:
        raise RuntimeError(f"run_joined needs the launcher's variables {LAUNCHER_VARIABLES}")
    store, _, _ = next(dist.rendezvous("env://"))
    _in_group(fn, args, device, env.local_rank, backend_for(device),
              store=dist.PrefixStore(f"anatomask_join{next(_JOINS)}", store), rank=env.rank,
              world_size=env.world)

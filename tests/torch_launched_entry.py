"""Port entries as torchrun starts them, for tests/test_torch_multinode.py:
`anatomask_torch.cli.main` (what `python -m anatomask_torch.cli` runs), with
spawning forbidden and each checkpoint file this process writes or links
printed as `[checkpoint] rank R wrote NAME`. Entries separated by `--` run
one after another in this process, each joining the launcher's group anew;
`-epochs N` before an entry trains its -tr preset for N epochs:

    torchrun --nnodes 2 --nproc_per_node 1 --node_rank K --master_addr 127.0.0.1 \\
        --master_port PORT tests/torch_launched_entry.py pretrain 965 ... -- \\
        -epochs 1 train 965 3d_fullres all -tr ATKTrainer_1epoch -device cpu
"""
import os
import sys
import time
from dataclasses import replace

import torch.multiprocessing

from anatomask_torch import cli
from anatomask_torch.parallel import mesh
from anatomask_torch.training import checkpoint as ckpt
from anatomask_torch.training import trainer as trainer_mod


def _no_spawn(*args, **kwargs):
    raise AssertionError("an entry spawned processes under the launcher")


def _recorded(write, name_at):
    """`write` printing the name of the file it makes (its argument name_at)."""
    def wrapped(*args, **kwargs):
        print(f"[checkpoint] rank {mesh.rank()} wrote {os.path.basename(args[name_at])}",
              flush=True)
        return write(*args, **kwargs)
    return wrapped


def _with_epochs(get_config, epochs):
    return lambda name: replace(get_config(name), num_epochs=epochs)


def main(argv):
    torch.multiprocessing.spawn = _no_spawn
    for name, name_at in (("save_checkpoint", 0), ("save_trainer_checkpoint", 0),
                          ("link_checkpoint", 1)):
        setattr(ckpt, name, _recorded(getattr(ckpt, name), name_at))
    get_config = trainer_mod.get_trainer_config
    entries, current = [], []
    for arg in argv + ["--"]:
        if arg == "--":
            entries.append(current)
            current = []
        else:
            current.append(arg)
    for entry in entries:
        trainer_mod.get_trainer_config = get_config
        if entry[0] == "-epochs":
            trainer_mod.get_trainer_config = _with_epochs(get_config, int(entry[1]))
            entry = entry[2:]
        t0 = time.perf_counter()
        cli.main(entry)
        print(f"[entry] rank {os.environ['RANK']}: {entry[0]} done in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Traffic driver `pretrain_trainer`: the port's `PretrainTrainer` an
iteration at a time, as `atk_torch_pretrain` runs its epochs: the next batch
(`next_batch`, the span `pretrain.data`: a sample of the device case cache,
whose staged refills run on a side stream, or the loader's next; the spatial
augmentation; the batch in the model's layout and dtype), then the
AnatoMask step at the schedule's LR (`train_step`).

Set-up writes a synthetic preprocessed dataset with the port's own writers
(`traffic.cases` cases of `traffic.case_shape` float32, noise with one
labelled brighter sphere, drawn from the seed on the run's device) into a
folder under `benchmark/out/` that the run removes, builds the trainer on it
(`PretrainTrainer`, the configuration's model, the traffic's cache, split,
oversampling and schedule), loads the benchmark's weights into the student
before the teacher is copied from it, sets the epoch, and runs the
`checked_steps` first iterations: it keeps the batches they delivered, the
mask generator's state before each step and each step's LR. The window
continues the same trainer; it holds training iterations only (an epoch's
validation and checkpoint come after `iters_per_epoch` of them).

The check is `pretrain_arch`'s: `reference/anatomask.py`'s steps with the
configuration's SparK forward (STUNet's) from the same weights, on the
delivered batches, draws and LRs, compared as `pretrain_step` compares.
"""
from __future__ import annotations

import gc
import os
import shutil
import tempfile
from dataclasses import replace
from pathlib import Path
from typing import List

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers import pretrain_arch
from benchmark.drivers.pretrain_arch import keep, kept, port_config
from benchmark.reference import anatomask

OUT = Path(__file__).resolve().parent.parent / "out"
DATASET = "Dataset990_BenchTrainer"


def write_dataset(root: Path, traffic: dict, patch: List[int], seed: int, device) -> None:
    """A preprocessed dataset as the port's preprocessor leaves it, under
    root/DATASET: each case `<key>.npz` (data, seg) with its properties
    (spacing, class locations), dataset.json and ATKPlans.json."""
    from anatomask_torch.plans.plans_handler import save_json
    from anatomask_torch.preprocessing.preprocessor import save_properties
    base = root / DATASET
    folder = base / "ATKPlans_3d_fullres"
    folder.mkdir(parents=True)
    shape = traffic["case_shape"]
    gen = inputs.generator(seed, inputs.DATA, device)
    n = traffic["cases"]
    spots = torch.rand((n, 4), generator=gen, device=device).cpu().numpy()
    rs = np.random.RandomState(inputs.subseed(seed, inputs.SAMPLE) % 2 ** 32)
    grid = np.ogrid[tuple(slice(0, s) for s in shape[1:])]
    for i in range(n):
        data = torch.randn(shape, generator=gen, device=device).cpu().numpy()
        r = 0.05 * min(shape[1:]) + spots[i, 3] * 0.075 * min(shape[1:])
        centre = [r + u * (s - 2 * r) for u, s in zip(spots[i, :3], shape[1:])]
        blob = sum((a - c) ** 2 for a, c in zip(grid, centre)) < r ** 2
        data[0][blob] += 2.0
        seg = blob[None].astype(np.int8)
        key = str(folder / f"case_{i:03d}")
        np.savez(key + ".npz", data=data, seg=seg)
        locs = np.argwhere(seg == 1)
        locs = locs[rs.choice(len(locs), min(len(locs), 10000), replace=False)]
        save_properties({"spacing": [1.0, 1.0, 1.0], "class_locations": {1: locs}}, key)
    save_json({"channel_names": {"0": "CT"}, "labels": {"background": 0, "sphere": 1},
               "numTraining": n, "file_ending": ".nii.gz"}, str(base / "dataset.json"))
    save_json({"dataset_name": DATASET, "plans_name": "ATKPlans",
               "configurations": {"3d_fullres": {
                   "data_identifier": "ATKPlans_3d_fullres", "patch_size": list(patch),
                   "spacing": [1.0] * 3}}}, str(base / "ATKPlans.json"))


class Cell(pretrain_arch.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        # len_loss and the EMA decay come from the trainer's schedule at the
        # traffic's epoch (`_build`)
        super().__init__(config, dict(traffic, keep_ratio=0.0, ema_decay=None), seed, device)
        self.trainer = self.folder = None

    # --- the program -------------------------------------------------------
    def _build(self):
        """The dataset and the trainer on it, with the benchmark's weights
        (returned too); the epoch's EMA decay and len_loss."""
        from anatomask_torch.data.dataset import unpack_dataset
        from anatomask_torch.ssl.pretrain import PretrainTrainer
        cfg, t = self.cfg, self.traffic
        if not hasattr(PretrainTrainer, "next_batch"):
            raise RuntimeError("the program's PretrainTrainer runs no single iteration "
                               "(next_batch, train_step)")
        OUT.mkdir(parents=True, exist_ok=True)
        self.folder = Path(tempfile.mkdtemp(prefix="trainer-dataset-", dir=OUT))
        write_dataset(self.folder, t, cfg["pretrain"]["patch_size"], self.seed, self.device)
        unpack_dataset(str(self.folder / DATASET / "ATKPlans_3d_fullres"), num_processes=1)
        pc = replace(port_config(cfg, self.batch), num_epochs=t["num_epochs"],
                     iters_per_epoch=t["iters_per_epoch"], val_fraction=t["val_fraction"],
                     oversample_foreground_percent=t["oversample_foreground_percent"],
                     device_cache=True, device_cache_mb=t["device_cache_mb"],
                     seed=inputs.subseed(self.seed, inputs.SAMPLE) % 2 ** 31)
        old = os.environ.get("ATK_preprocessed")
        os.environ["ATK_preprocessed"] = str(self.folder)
        try:
            trainer = PretrainTrainer(DATASET, pc, output_folder=str(self.folder / "results"),
                                      device=self.device)
        finally:
            if old is None:
                del os.environ["ATK_preprocessed"]
            else:
                os.environ["ATK_preprocessed"] = old
        w0 = inputs.make_weights(self.reference.spark_params(cfg), self.seed, self.device)
        trainer.model.load_state_dict(w0, strict=True)
        trainer.get_dataloaders()
        trainer.initialize()
        trainer.current_epoch = t["epoch"]
        self.ema_decay, _, self.len_loss = trainer.epoch_settings(t["epoch"])
        self.trainer = trainer
        return trainer, w0

    def setup(self) -> None:
        trainer, w0 = self._build()
        self.losses: List[torch.Tensor] = []
        self.batches, self.lrs = [], []
        rec = {"loss": [], "hard": [], "loss_map": []}
        for _ in range(self.checked):
            x = trainer.next_batch()
            self.batches.append(x.clone())
            self.noise_states.append(trainer.mask_generator.get_state())
            self.lrs.append(trainer.lr_schedule(trainer._optimizer_count()))
            keep(rec, trainer.train_step(x, self.len_loss, self.ema_decay), trainer.model,
                 trainer.optimizer)
        self.program = kept(rec, trainer.model, trainer.teacher, w0)
        del w0
        self._step = lambda: self.losses.append(trainer.train_step(
            trainer.next_batch(), self.len_loss, self.ema_decay)[0].detach())

    def release(self) -> None:
        if self.trainer is not None:
            self.trainer.stop_data()
        self._step = self.trainer = None
        if self.folder is not None:
            shutil.rmtree(self.folder, ignore_errors=True)
            self.folder = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the reference --------------------------------------------------------
    def stand_in(self, q=anatomask.EXACT, batch_fraction: float = 1.0) -> None:
        """`pretrain_arch`'s stand-in on the batches the trainer delivers, at the
        LRs of its schedule, with fresh draws."""
        trainer = self._build()[0]
        self.batches = [trainer.next_batch().clone() for _ in range(self.checked)]
        self.lrs = [trainer.lr_schedule(k) for k in range(self.checked)]
        self.release()
        super().stand_in(q, batch_fraction)

    def checked_batches(self) -> List[torch.Tensor]:
        return [x.float() for x in self.batches]

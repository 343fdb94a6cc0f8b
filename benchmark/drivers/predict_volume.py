"""Traffic driver `predict_volume`: the port's sliding-window prediction of
one case (`anatomask_torch.inference.predictor.Predictor.
predict_sliding_window_return_logits`, the logits back on the host as
numpy), closed loop, whole cases back to back on a pool of distinct volumes
cycled in order.

Set-up builds the segmentation network from plans as the Predictor's users
do, loads the benchmark's weights as the one fold, and predicts the pool's
first volume once to warm every shape up. In the window each pool volume
keeps one case for the check, drawn from the seed among its first
`sample_span` cases (the last it reached where the window ended first).

The check (after the window, the program's state freed) runs the plain
reference's sliding window over the same volumes and compares the logits.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import stunet as reference
from benchmark.yardstick import stunet as yardstick


class Cell:
    unit = "case"
    end_to_end = "predict_case_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        n = traffic["pool_volumes"]
        rng = random.Random(inputs.subseed(seed, inputs.SAMPLE))
        self.targets = [v + n * rng.randrange(traffic["sample_span"]) for v in range(n)]
        self.kept: Dict[int, np.ndarray] = {}  # pool volume -> the logits kept for the check
        self.shape_errors = 0
        self.case_no = 0

    def _volumes(self) -> List[np.ndarray]:
        n, shape = self.traffic["pool_volumes"], self.traffic["volume_shape"]
        data = inputs.normal_data((n, *shape), self.seed, self.device).cpu().numpy()
        return [data[i] for i in range(n)]

    def setup(self) -> None:
        from anatomask_torch.inference.predictor import Predictor
        from anatomask_torch.models.build import build_network_from_plans
        from anatomask_torch.plans.plans_handler import PlansManager
        cfg, t, seg = self.cfg, self.traffic, self.cfg["segmentation"]
        plans = {"dataset_name": "Dataset000_Benchmark", "plans_name": "benchmarkPlans",
                 "configurations": {"3d_fullres": {
                     "patch_size": seg["patch_size"], "UNet_class_name": seg["arch_name"],
                     "pool_op_kernel_sizes": seg["pool_op_kernel_sizes"],
                     "conv_kernel_sizes": seg["conv_kernel_sizes"]}}}
        labels = {"background": 0, **{f"label{k}": k for k in range(1, cfg["num_classes"])}}
        dataset_json = {"labels": labels,
                        "channel_names": {str(c): "CT" for c in range(cfg["in_channels"])}}
        pm = PlansManager(plans)
        cm = pm.get_configuration("3d_fullres")
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["compute_dtype"]]
        net = build_network_from_plans(pm, cm, cfg["in_channels"], cfg["num_classes"],
                                       deep_supervision=False, dtype=dtype, device=self.device)
        w0 = inputs.make_weights(reference.segnet_params(cfg), self.seed, self.device)
        net.load_state_dict(w0, strict=True)
        predictor = Predictor(tile_step_size=t["tile_step_size"], use_gaussian=t["use_gaussian"],
                              use_mirroring=bool(t["mirror_axes"]),
                              tile_batch_size=t["tile_batch_size"], dtype=dtype,
                              device=self.device)
        predictor.manual_initialization(net, pm, cm, [w0], dataset_json,
                                        tuple(t["mirror_axes"]))
        self.volumes = self._volumes()
        self.predict = predictor.predict_sliding_window_return_logits
        self.predict(self.volumes[0])  # warm-up

    def run(self, seconds: float, min_units: int = 1) -> int:
        """Whole cases back to back until `seconds` have passed and at least
        `min_units` ran; returns the cases."""
        n, t0 = 0, time.perf_counter()
        want = (self.cfg["num_classes"], *self.traffic["volume_shape"][1:])
        while n < min_units or time.perf_counter() - t0 < seconds:
            v = self.case_no % len(self.volumes)
            logits = self.predict(self.volumes[v])
            if logits.shape != want:
                self.shape_errors += 1
            elif self.case_no <= self.targets[v]:
                self.kept[v] = logits
            self.case_no += 1
            n += 1
        return n

    def failed(self) -> int:
        """Cases whose logits came back in the wrong shape, or kept ones not
        finite."""
        return self.shape_errors + sum(not np.isfinite(k).all() for k in self.kept.values())

    def end_to_end_value(self, units: int, seconds: float) -> float:
        return seconds / units

    def work(self, peak: dict) -> yardstick.Work:
        """The yardstick's count of one case against the device's peaks."""
        t, seg = self.traffic, self.cfg["segmentation"]
        bf16 = self.cfg["compute_dtype"] == "bfloat16"
        rate = peak["bf16_flops"] if bf16 else peak["tf32_flops"] / 3
        tiles = yardstick.tile_count(t["volume_shape"][1:], seg["patch_size"],
                                     t["tile_step_size"])
        return yardstick.predict_case(self.cfg, tiles, 2 ** len(t["mirror_axes"]),
                                      t["tile_batch_size"], rate, peak["bytes_per_s"],
                                      2 if bf16 else 4)

    def counters(self) -> Dict[str, int]:
        from anatomask_torch.ops import conv3x3, zslab_conv
        return {"conv": conv3x3.conv3d_3x3.launches + zslab_conv.conv3d_zslab.launches}

    def release(self) -> None:
        self.predict = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, volume: np.ndarray, q: reference.Quant, P0) -> np.ndarray:
        t = self.traffic
        with reference.float32_exact():
            out = reference.sliding_window_logits(
                P0, self.cfg, torch.from_numpy(volume).to(self.device),
                self.cfg["segmentation"]["patch_size"], t["tile_step_size"], t["mirror_axes"], q)
        return out.cpu().numpy()

    def stand_in(self, q: reference.Quant = reference.EXACT, volumes: Optional[int] = None
                 ) -> None:
        """The reference in the program's place, at `q`'s arithmetic, over
        each pool volume (the first `volumes`)."""
        P0 = inputs.make_weights(reference.segnet_params(self.cfg), self.seed, self.device)
        vols = self._volumes()[:volumes]
        self.kept = {v: self._reference(x, q, P0) for v, x in enumerate(vols)}

    def check(self) -> Dict[str, float]:
        """logits_rel_max: max |logits - reference's| / max |reference's| of
        the worst kept case (its root mean square, which swings more from
        seed to seed than the control leaves room for, is kept in
        `detail`)."""
        P0 = inputs.make_weights(reference.segnet_params(self.cfg), self.seed, self.device)
        vols = self._volumes()
        rms = mx = float("inf") if not self.kept else 0.0
        for v, got in sorted(self.kept.items()):
            want = self._reference(vols[v], reference.EXACT, P0)
            d = got.astype(np.float64) - want
            rms = max(rms, float(np.linalg.norm(d) / np.linalg.norm(want)))
            mx = max(mx, float(np.abs(d).max() / np.abs(want).max()))
        self.detail = {"logits_rel_rms": rms}
        return {"logits_rel_max": mx}

"""Traffic driver `pretrain_step`: the port's AnatoMask pretraining step
(`anatomask_torch.ssl.pretrain.anatomask_train_step`), closed loop, whole
steps back to back on a pool of distinct batches cycled in order.

Set-up builds the student, its EMA teacher and AdamW as the port's trainer
does, loads the benchmark's weights, and drives that same object through
the configuration's `checked_steps` first steps on the pool's first
batches; those steps are the warm-up and what the check compares. The
window continues the same object on the next batches.

The check (after the window, the program's state freed) runs the plain
reference from the same weights on the same batches and draws. The
reference follows the program's hard masks, which it first holds against
its own teacher's per-patch loss (`forced_gap`) and rebuilds from the
program's loss map (`hard_mask_wrong`).
"""
from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

import torch

from benchmark import inputs
from benchmark.reference import stunet as reference
from benchmark.yardstick import stunet as yardstick

CL3D = torch.channels_last_3d


@torch.no_grad()
def _norms(tensors: Dict[str, torch.Tensor], minus: Optional[Dict[str, torch.Tensor]] = None
           ) -> Dict[str, float]:
    """Each tensor's 2-norm (of its difference to `minus`), read in one sync."""
    names = list(tensors)
    vals = [(tensors[n].float() - (minus[n] if minus else 0)).norm() for n in names]
    return dict(zip(names, torch.stack(vals).tolist()))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves: List[str]
              ) -> Dict[str, float]:
    """Each leaf's gap between two norms, over the larger of the reference's
    norm of that leaf and its median leaf's."""
    med = sorted(want[n] for n in leaves)[len(leaves) // 2]
    return {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in leaves}


def worst(gaps: Dict[str, float], got: Dict[str, float], want: Dict[str, float], n: int = 4
          ) -> list:
    """The n widest gaps: (leaf, gap, program's norm, reference's norm)."""
    top = sorted(gaps, key=gaps.get, reverse=True)[:n]
    return [(k, gaps[k], got[k], want[k]) for k in top]


class Cell:
    unit = "step"
    end_to_end = "train_patches_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        p = config["pretrain"]
        self.batch = traffic["batch"]
        self.fmap = [s >> (p["encoder_stages"] - 1) for s in p["patch_size"]]
        L = math.prod(self.fmap)
        self.len_keep = round(L * (1 - p["mask_ratio"]))
        self.len_loss = int((L - self.len_keep) * traffic["keep_ratio"])
        self.checked = config["checked_steps"]
        self.program: Optional[dict] = None   # what the checked steps produced
        self.noise_states: List[torch.Tensor] = []

    # --- the program -------------------------------------------------------
    def _pool(self, dtype) -> List[torch.Tensor]:
        B, n = self.batch, self.traffic["pool_batches"]
        p = self.cfg["pretrain"]
        data = inputs.normal_data((n * B, self.cfg["in_channels"], *p["patch_size"]), self.seed,
                                  self.device).to(dtype)
        return [data[i * B:(i + 1) * B].contiguous(memory_format=CL3D) for i in range(n)]

    def setup(self) -> None:
        from anatomask_torch.ssl.pretrain import (PretrainConfig, anatomask_train_step,
                                                  build_spark_model, make_optimizer,
                                                  make_teacher)
        cfg, p = self.cfg, self.cfg["pretrain"]
        n = p["encoder_stages"]
        pc = PretrainConfig(
            method="anatomask", model_size=cfg["model_size"], patch_size=tuple(p["patch_size"]),
            batch_size=self.batch, mask_ratio=p["mask_ratio"], densify_norm=p["densify_norm"],
            decoder_norm=p["decoder_norm"], decoder_width=p["decoder_width"], lr=p["lr"],
            optimizer=p["optimizer"], weight_decay=p["weight_decay"], grad_clip=p["grad_clip"],
            compute_dtype=cfg["compute_dtype"], remat=p["remat"],
            grad_accum_steps=p["grad_accum_steps"],
            encoder_dims=tuple(cfg["stage_widths"][:n]),
            encoder_depth=tuple(cfg["blocks_per_stage"][:n]))
        self.pc = pc
        model = build_spark_model(pc, cfg["in_channels"], self.device)
        w0 = inputs.make_weights(reference.spark_params(cfg), self.seed, self.device)
        model.load_state_dict(w0, strict=True)
        if (model.len_keep, list(model.fmap)) != (self.len_keep, self.fmap):
            raise RuntimeError(f"the program's mask grid {model.fmap}, keep {model.len_keep} "
                               f"differ from the configuration's {self.fmap}, {self.len_keep}")
        teacher = make_teacher(model)
        opt = make_optimizer(model, pc)
        self.pool = self._pool(model.dtype)
        self.gen = inputs.generator(self.seed, inputs.NOISE, self.device)
        self.losses: List[torch.Tensor] = []
        self.step_no = 0

        def step(record: Optional[dict] = None):
            x = self.pool[self.step_no % len(self.pool)]
            if record is not None:
                self.noise_states.append(self.gen.get_state())
            loss, hard, loss_map = anatomask_train_step(
                model, teacher, opt, x, self.len_loss, self.gen,
                ema_decay=self.traffic["ema_decay"], lr=p["lr"], grad_clip=p["grad_clip"],
                grad_accum_steps=p["grad_accum_steps"])
            self.step_no += 1
            if record is not None:
                record["loss"].append(loss.detach())
                record["hard"].append(hard.reshape(hard.shape[0], -1).clone())
                record["loss_map"].append(loss_map.detach().clone())
            else:
                self.losses.append(loss.detach())

        self._step, self._objects = step, (model, teacher, opt)
        rec = {"loss": [], "hard": [], "loss_map": []}
        b1 = opt.param_groups[0]["betas"][0]
        for k in range(self.checked):
            step(rec)
            if k == 0:  # the first gradient, as AdamW got it: m1 = (1 - b1) g
                rec["grad"] = _norms({n: opt.state[q]["exp_avg"] / (1 - b1)
                                      if "exp_avg" in opt.state.get(q, {})
                                      else torch.zeros_like(q)
                                      for n, q in model.named_parameters()})
        rec["student_change"] = _norms(dict(model.named_parameters()), w0)
        rec["teacher_change"] = _norms(dict(teacher.named_parameters()), w0)
        self.program = _to_host(rec)
        del w0

    def run(self, seconds: float, min_units: int = 1) -> int:
        """Whole steps back to back until `seconds` have passed and at least
        `min_units` ran, then a synchronize; returns the steps."""
        import time
        n, t0 = 0, time.perf_counter()
        while n < min_units or time.perf_counter() - t0 < seconds:
            self._step()
            n += 1
        _synchronize(self.device)
        return n

    def failed(self) -> int:
        """Steps of the window whose loss is not finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def end_to_end_value(self, units: int, seconds: float) -> float:
        return units * self.batch / seconds

    def work(self, peak: dict) -> yardstick.Work:
        """The yardstick's count of one step against the device's peaks."""
        bf16 = self.cfg["compute_dtype"] == "bfloat16"
        rate = peak["bf16_flops"] if bf16 else peak["tf32_flops"] / 3
        return yardstick.pretrain_step(self.cfg, self.batch, rate, peak["bytes_per_s"],
                                       2 if bf16 else 4)

    def counters(self) -> Dict[str, int]:
        """The port's launch counters of kernels #1 and #2, where it has them."""
        from anatomask_torch.ops import conv3x3, zslab_conv
        return {"conv": conv3x3.conv3d_3x3.launches + zslab_conv.conv3d_zslab.launches}

    def release(self) -> None:
        self._step = self._objects = self.pool = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- a stand-in for the program (the control, a fault) ----------------
    def stand_in(self, q: reference.Quant = reference.EXACT, batch_fraction: float = 1.0) -> None:
        """The reference in the program's place, at `q`'s arithmetic, with the
        student's loss over `batch_fraction` of each batch."""
        P0, batches, noises = self._reference_inputs(fresh_noise=True)
        with reference.float32_exact():
            ref = reference.anatomask_steps(P0, self.cfg, batches, noises, self.len_loss,
                                            self.traffic["ema_decay"], q=q,
                                            batch_fraction=batch_fraction)
        self.program = _to_host(_record(ref, P0))

    # --- the check -----------------------------------------------------------
    def _reference_inputs(self, fresh_noise: bool = False):
        P0 = inputs.make_weights(reference.spark_params(self.cfg), self.seed, self.device)
        pool = self._pool(torch.bfloat16 if self.cfg["compute_dtype"] == "bfloat16"
                          else torch.float32)
        batches = [pool[k % len(pool)].float() for k in range(self.checked)]
        if fresh_noise:
            gen = inputs.generator(self.seed, inputs.NOISE, self.device)
            self.noise_states = []
            for _ in range(self.checked):
                self.noise_states.append(gen.get_state())
                torch.rand((2, self.batch, math.prod(self.fmap)), generator=gen,
                           device=self.device)
        noises = []
        for state in self.noise_states:
            gen = torch.Generator(device=self.device)
            gen.set_state(state)
            noises.append(torch.rand((2, self.batch, math.prod(self.fmap)), generator=gen,
                                     device=self.device))
        return P0, batches, noises

    def check(self) -> Dict[str, float]:
        """The numbers that decide `correct`, each against the reference."""
        P0, batches, noises = self._reference_inputs()
        prog = self.program
        hard = [h.to(self.device) for h in prog["hard"]]
        with reference.float32_exact():
            ref = _to_host(_record(reference.anatomask_steps(
                P0, self.cfg, batches, noises, self.len_loss, self.traffic["ema_decay"],
                hard_masks=hard), P0))
        numbers, self.detail = compare(prog, ref, [n.cpu() for n in noises], self.len_loss,
                                       self.len_keep, self.fmap)
        return numbers


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _record(ref: dict, P0: Dict[str, torch.Tensor]) -> dict:
    """The compared parts of a reference run."""
    return {"loss": ref["loss"], "hard": ref["hard"], "loss_map": ref["loss_map"],
            "grad": _norms(ref["grad"]),
            "student_change": _norms(ref["student"], P0),
            "teacher_change": _norms(ref["teacher"], P0)}


def _to_host(rec: dict) -> dict:
    out = dict(rec)
    out["loss"] = [float(v) for v in rec["loss"]]
    out["hard"] = [h.reshape(h.shape[0], -1).bool().cpu() for h in rec["hard"]]
    out["loss_map"] = [m.float().cpu() for m in rec["loss_map"]]
    return out


def compare(prog: dict, ref: dict, noises: List[torch.Tensor], len_loss: int, len_keep: int,
            fmap: List[int]):
    """The compared numbers of a pretraining cell:

    - loss_rel: the worst step's |loss - reference's| / reference's;
    - loss_map_rel: the worst step's ||teacher's per-patch loss -
      reference's|| / ||reference's||;
    - forced_gap: the widest gap by which a patch the program forced lies
      below the reference's len_loss-th highest loss of its sample, over
      that loss;
    - hard_mask_wrong: patches where the program's hard mask differs from
      the one rebuilt from its own loss map and draws (exact);
    - grad_leaf_gap: the first step's clipped gradient, worst leaf (gap of
      norms over the larger of the reference's norm and its median leaf's);
    - update_leaf_gap, ema_leaf_gap: the student's and the teacher's change
      over the checked steps, worst leaf, leaving out the leaves whose
      reference gradient is under a thousandth of the median leaf's (biases
      before an instance norm, parameters no output reads), which move by
      round-off alone.

    Returns the numbers and, for each leaf measure, its widest leaves."""
    out = {"loss_rel": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))}
    out["loss_map_rel"] = max(float((a - b).norm() / b.norm())
                              for a, b in zip(prog["loss_map"], ref["loss_map"]))
    gap, wrong = 0.0, 0
    for lm_p, lm_r, hard, noise in zip(prog["loss_map"], ref["loss_map"], prog["hard"], noises):
        forced = reference.forced_patches(lm_p, len_loss)
        thr = lm_r.sort(1, descending=True).values[:, len_loss - 1:len_loss].clamp_min(1e-30)
        below = torch.where(forced, (thr - lm_r) / thr, torch.zeros_like(lm_r))
        gap = max(gap, float(below.max()))
        rebuilt = reference.guided_mask(forced, noise[1], len_keep, fmap)
        wrong += int((rebuilt.reshape(hard.shape) != hard).sum())
    out["forced_gap"] = gap
    out["hard_mask_wrong"] = float(wrong)
    names = list(ref["grad"])
    g = sorted(ref["grad"].values())
    moving = [n for n in names if ref["grad"][n] >= 1e-3 * g[len(g) // 2]]
    detail = {}
    for key, leaves, number in (("grad", names, "grad_leaf_gap"),
                                ("student_change", moving, "update_leaf_gap"),
                                ("teacher_change", moving, "ema_leaf_gap")):
        gaps = leaf_gaps(prog[key], ref[key], leaves)
        out[number] = max(gaps.values())
        detail[number] = worst(gaps, prog[key], ref[key])
        if key == "grad":
            detail["grad_global_gap"] = abs(math.hypot(*prog[key].values())
                                            - math.hypot(*ref[key].values())) / math.hypot(
                                                *ref[key].values())
    # the worst leaf's gradient gap is that of a leaf whose gradient an
    # instance norm all but cancels (rounding noise against a small
    # residual): the median leaf's gap is the number compared
    gaps = leaf_gaps(prog["grad"], ref["grad"], names)
    detail["grad_leaf_gap"] = out.pop("grad_leaf_gap")
    out["grad_median_gap"] = sorted(gaps.values())[len(gaps) // 2]
    return out, detail

"""Traffic driver `pretrain_arch`: `pretrain_step`'s cell for any SparK
encoder the port builds. The configuration names the port's encoder
(`arch`: "stunet" or "mednext", `PretrainConfig.encoder_type`), its plain
reference (`reference/<reference>.py`, whose SparK forward runs in
`reference/anatomask.py`'s step) and its yardstick (`yardstick/<arch>.py`);
the pool, the window, the checked steps and the compared numbers are
`pretrain_step`'s.

Set-up builds the SparK through `build_spark_model`, as the port's trainer
and `atk_torch_pretrain` build it, and loads the benchmark's weights into it
by name (`strict`: a width, a block count, an expansion or a kernel size the
port does not build fails there).
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List

import torch

from benchmark import inputs
from benchmark.drivers import pretrain_step
from benchmark.drivers.pretrain_step import _norms, _record, _to_host, compare
from benchmark.reference import anatomask


def port_config(cfg: dict, batch: int):
    """The port's PretrainConfig of a configuration file."""
    from anatomask_torch.ssl.pretrain import PretrainConfig
    p, n = cfg["pretrain"], cfg["pretrain"]["encoder_stages"]
    arch = dict(encoder_type="mednext") if cfg["arch"] == "mednext" else dict(
        model_size=cfg["model_size"], encoder_depth=tuple(cfg["blocks_per_stage"][:n]))
    return PretrainConfig(
        method="anatomask", patch_size=tuple(p["patch_size"]), batch_size=batch,
        mask_ratio=p["mask_ratio"], densify_norm=p["densify_norm"],
        decoder_norm=p["decoder_norm"], decoder_width=p["decoder_width"], lr=p["lr"],
        optimizer=p["optimizer"], weight_decay=p["weight_decay"], grad_clip=p["grad_clip"],
        compute_dtype=cfg["compute_dtype"], remat=p["remat"],
        grad_accum_steps=p["grad_accum_steps"], encoder_dims=tuple(cfg["stage_widths"][:n]),
        **arch)


def keep(rec: dict, out, model, opt) -> None:
    """Keep in `rec` what a checked step produced (`out`: its loss, hard mask
    and the teacher's loss map) and, after the first step, its gradient as
    AdamW got it: m1 = (1 - b1) g."""
    loss, hard, loss_map = out
    rec["loss"].append(loss.detach())
    rec["hard"].append(hard.reshape(hard.shape[0], -1).clone())
    rec["loss_map"].append(loss_map.detach().clone())
    if "grad" not in rec:
        b1 = opt.param_groups[0]["betas"][0]
        rec["grad"] = _norms({n: opt.state[q]["exp_avg"] / (1 - b1)
                              if "exp_avg" in opt.state.get(q, {}) else torch.zeros_like(q)
                              for n, q in model.named_parameters()})


def kept(rec: dict, model, teacher, w0: Dict[str, torch.Tensor]) -> dict:
    """`rec` with the student's and the teacher's change from w0, on the host."""
    rec["student_change"] = _norms(dict(model.named_parameters()), w0)
    rec["teacher_change"] = _norms(dict(teacher.named_parameters()), w0)
    return _to_host(rec)


class Cell(pretrain_step.Cell):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.reference = importlib.import_module(f"benchmark.reference.{config['reference']}")
        self.yardstick = importlib.import_module(f"benchmark.yardstick.{config['arch']}")
        self.ema_decay = traffic["ema_decay"]
        self.lrs = None  # each checked step's LR; None: the configuration's lr

    def setup(self) -> None:
        from anatomask_torch.ssl.pretrain import (anatomask_train_step, build_spark_model,
                                                  make_optimizer, make_teacher)
        cfg, p = self.cfg, self.cfg["pretrain"]
        pc = port_config(cfg, self.batch)
        model = build_spark_model(pc, cfg["in_channels"], self.device)
        w0 = inputs.make_weights(self.reference.spark_params(cfg), self.seed, self.device)
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

        def step():
            x = self.pool[self.step_no % len(self.pool)]
            self.step_no += 1
            return anatomask_train_step(
                model, teacher, opt, x, self.len_loss, self.gen, ema_decay=self.ema_decay,
                lr=p["lr"], grad_clip=p["grad_clip"], grad_accum_steps=p["grad_accum_steps"])

        rec = {"loss": [], "hard": [], "loss_map": []}
        for _ in range(self.checked):
            self.noise_states.append(self.gen.get_state())
            keep(rec, step(), model, opt)
        self.program = kept(rec, model, teacher, w0)
        self._step = lambda: self.losses.append(step()[0].detach())
        self._objects = (model, teacher, opt)

    def work(self, peak: dict):
        bf16 = self.cfg["compute_dtype"] == "bfloat16"
        rate = peak["bf16_flops"] if bf16 else peak["tf32_flops"] / 3
        return self.yardstick.pretrain_step(self.cfg, self.batch, rate, peak["bytes_per_s"],
                                            2 if bf16 else 4)

    # --- the reference --------------------------------------------------------
    def reference_steps(self, P0, batches, noises, **kw) -> dict:
        """`reference/anatomask.py`'s steps with this configuration's SparK
        forward, from P0, TF32 off."""
        with self.reference.float32_exact():
            return anatomask.anatomask_steps(self.reference.spark_forward, P0, self.cfg,
                                             batches, noises, self.len_loss, self.ema_decay,
                                             lrs=self.lrs, **kw)

    def stand_in(self, q=anatomask.EXACT, batch_fraction: float = 1.0) -> None:
        """The reference in the program's place, at `q`'s arithmetic, with the
        student's loss over `batch_fraction` of each batch."""
        P0, batches, noises = self._reference_inputs(fresh_noise=True)
        ref = self.reference_steps(P0, batches, noises, q=q, batch_fraction=batch_fraction)
        self.program = _to_host(_record(ref, P0))

    def checked_batches(self) -> List[torch.Tensor]:
        """The checked steps' batches in float32."""
        pool = self._pool(torch.bfloat16 if self.cfg["compute_dtype"] == "bfloat16"
                          else torch.float32)
        return [pool[k % len(pool)].float() for k in range(self.checked)]

    def _reference_inputs(self, fresh_noise: bool = False):
        """`pretrain_step`'s (weights, batches, uniforms), the weights from this
        configuration's reference table."""
        P0 = inputs.make_weights(self.reference.spark_params(self.cfg), self.seed, self.device)
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
        return P0, self.checked_batches(), noises

    def check(self) -> Dict[str, float]:
        """The numbers that decide `correct`, each against the reference."""
        P0, batches, noises = self._reference_inputs()
        prog = self.program
        hard = [h.to(self.device) for h in prog["hard"]]
        ref = _to_host(_record(self.reference_steps(P0, batches, noises, hard_masks=hard), P0))
        numbers, self.detail = compare(prog, ref, [n.cpu() for n in noises], self.len_loss,
                                       self.len_keep, self.fmap)
        return numbers

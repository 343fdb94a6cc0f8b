"""The port's MedNeXt SparK (`ssl/mednext.py` under `ssl/spark.py`, built by
`build_spark_model`) against the benchmark's plain reference
(`benchmark/reference/mednext.py`, with the AnatoMask step of
`benchmark/reference/anatomask.py`) on the CPU at a tiny size: widths 4-64
with the published blocks (2 a stage), expansion 4 and depthwise 7^3 kernel,
a 32^3 patch, batch 2, seeded random weights loaded into both by
name, in float32. Compared: the reconstruction under a random mask, the AnatoMask
loss and the teacher's loss map, the hard mask bit for bit, every leaf's
clipped gradient, and one AdamW update with its EMA. The same comparison of
the port in bf16 fails. And a grouped conv hands `F.conv3d` an
NCDHW-contiguous input, whatever the layout it gets, and saves the x it got.

Tolerances (both sides float32; the port sums its convs and norms in other
orders than the reference, per sample against the batch, and the norms'
statistics over a bottleneck of 2^3 voxels, 3 of them visible, amplify the
round-off). Measured over three seeds (3, 11, 2^31 + 5; this test
runs 11, the best conditioned), against the bf16 port's:
- reconstruction, max |diff| over the reference's max |value|: <= 2.4e-5
  (bf16 >= 2.6e-2): 1e-4;
- loss, relative: <= 1.2e-7 (bf16 >= 1.0e-5): 2e-6; loss map, relative
  2-norm: <= 6.5e-8 (bf16 >= 4.0e-5): 1e-6;
- hard mask: equal (a loss map within round-off picks the same patches);
- each leaf's clipped gradient, max |diff| over the larger of the leaf's max
  |value| and the median leaf's: <= 2.8e-3 (bf16 >= 0.76): 1e-2;
- the update: AdamW's first step moves an element by lr times the sign of
  its gradient, so an element whose gradient is round-off may move the other
  way; elements whose change differs by more than lr / 2: <= 0.02% (bf16 >=
  9.6%): 0.1%; the EMA teacher the same at (1 - decay) times lr.
"""
import json
import math

import torch
import torch.nn.functional as F

from anatomask_torch.models import layers
from anatomask_torch.ssl.pretrain import (PretrainConfig, anatomask_train_step,
                                          build_spark_model, make_optimizer, make_teacher)
from anatomask_torch.ssl.spark import random_keep_mask
from benchmark import harness, inputs
from benchmark.reference import anatomask
from benchmark.reference import mednext as reference

B, PATCH, LEN_LOSS, DECAY, LR = 2, (32, 32, 32), 2, 0.999, 1e-4
TOL = {"recon": 1e-4, "loss": 2e-6, "loss_map": 1e-6, "grad": 1e-2, "update": 1e-3,
       "ema": 1e-3}


def tiny_config() -> dict:
    cfg = json.loads((harness.ROOT / "benchmark/configs/mednext-k7.json").read_text())
    cfg["stage_widths"] = [4, 8, 16, 32, 64]
    cfg["pretrain"].update(decoder_width=64, patch_size=list(PATCH))
    return cfg


def gaps(seed: int, dtype: str) -> dict:
    """Each compared number of the port at `dtype` against the reference."""
    cfg = tiny_config()
    pc = PretrainConfig(encoder_type="mednext", encoder_dims=(4,), decoder_width=64,
                        patch_size=PATCH, compute_dtype=dtype, lr=LR)
    student = build_spark_model(pc, 1, "cpu")
    P0 = inputs.make_weights(reference.spark_params(cfg), seed, "cpu")
    student.load_state_dict(P0, strict=True)
    teacher, opt = make_teacher(student), make_optimizer(student, pc)
    x = inputs.normal_data((B, 1, *PATCH), seed, "cpu")
    noise = torch.rand((2, B, math.prod(student.fmap)), generator=torch.Generator().manual_seed(7))
    out = {}

    active = random_keep_mask(B, student.fmap, student.len_keep, noise=noise[0])
    with torch.no_grad():
        rec = student(x.to(student.dtype), active)[1].float()
    want = torch.cat([reference.spark_forward(P0, cfg, x[i:i + 1], active[i:i + 1])[1]
                      for i in range(B)])
    out["recon"] = float((rec - want).abs().max() / want.abs().max())

    loss, hard, loss_map = anatomask_train_step(student, teacher, opt, x.to(student.dtype),
                                                LEN_LOSS, noise=noise, ema_decay=DECAY, lr=LR)
    ref = anatomask.anatomask_steps(reference.spark_forward, P0, cfg, [x], [noise], LEN_LOSS,
                                    DECAY)
    out["loss"] = abs(loss.item() - ref["loss"][0].item()) / ref["loss"][0].item()
    out["loss_map"] = float((loss_map - ref["loss_map"][0]).norm() / ref["loss_map"][0].norm())
    out["hard_wrong"] = int((hard.reshape(B, -1) != ref["hard"][0]).sum())

    b1 = opt.param_groups[0]["betas"][0]
    peaks = {n: g.abs().max().item() for n, g in ref["grad"].items()}
    median = sorted(peaks.values())[len(peaks) // 2]
    out["grad"] = max(float((opt.state[q]["exp_avg"] / (1 - b1) - ref["grad"][n]).abs().max())
                      / max(peaks[n], median) for n, q in student.named_parameters())
    ema = dict(teacher.named_parameters())
    for key, got, want, step in (("update", dict(student.named_parameters()), ref["student"], LR),
                                 ("ema", ema, ref["teacher"], (1 - DECAY) * LR)):
        off = sum(int(((got[n].detach() - w).abs() > step / 2).sum()) for n, w in want.items())
        out[key] = off / sum(w.numel() for w in want.values())
    return out


def test_port_matches_the_reference_in_float32():
    got = gaps(11, "float32")
    assert got.pop("hard_wrong") == 0
    for name, value in got.items():
        assert value <= TOL[name], (name, value)


def test_bfloat16_port_fails_the_comparison():
    got = gaps(3, "bfloat16")
    got.pop("hard_wrong")
    assert [n for n, v in got.items() if v > TOL[n]], got


def test_grouped_conv_gets_a_contiguous_input_and_saves_x_as_given(monkeypatch):
    """The depthwise conv hands `F.conv3d` an NCDHW-contiguous x, and its
    autograd saves the channels_last_3d x it was given (a down block's
    residual conv saves that same x) and not the copy; values and gradients
    are those of one `F.conv3d` with its own autograd, bit for bit."""
    seen, saved = [], []
    conv3d = F.conv3d
    monkeypatch.setattr(layers.fn, "conv3d",
                        lambda x, *a, **k: seen.append(x.is_contiguous()) or conv3d(x, *a, **k))
    conv = layers.ConvND(8, 8, 7, stride=2, groups=8,
                         generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 6, 5, 4).contiguous(memory_format=torch.channels_last_3d)
    x.requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = conv(x)
    assert seen == [True]
    assert [t.data_ptr() for t in saved if t.shape == x.shape] == [x.data_ptr()]
    dy = torch.randn_like(y)
    dx, dw = torch.autograd.grad(y, (x, conv.weight), dy)
    x2, w2 = x.detach().contiguous().requires_grad_(True), conv.weight.detach().requires_grad_(True)
    want = conv3d(x2, w2, conv.bias, 2, 3, groups=8)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    for got, ref in zip((dx, dw), torch.autograd.grad(want, (x2, w2), dy)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)

"""Named phase spans of the pretraining step and the sliding window.

`span(name)` is `torch.profiler.record_function(name)` while PyTorch's
profiler runs (`torch.profiler.profile`, or `torch.autograd.profiler.
emit_nvtx` for nsys), so that the span lands in the profiler's trace beside
the kernels it launched, on the same clock. Otherwise it is one shared null
context: a flag check, no `RecordFunction` (a bare `record_function` costs
microseconds a call even with the profiler off). No clock, buffer or
exporter of its own.
"""
from __future__ import annotations

import contextlib

import torch

# every span the port opens; the benchmark's per-phase readers read them by name
SPANS = (
    "pretrain.step",            # one a step (anatomask_train_step, spark_train_step)
    "pretrain.data",            # beside a step: PretrainTrainer.next_batch (cache or loader,
                                # augmentation, the model's layout and dtype)
    "pretrain.teacher",         # a microbatch: random mask, teacher forward, per-patch loss
    "pretrain.hard_mask",       # a microbatch: generate_guided_mask
    "pretrain.student_forward",  # a microbatch: the student's forward and loss
    "pretrain.backward",        # a microbatch: loss.backward(), recomputed forwards included
    "pretrain.update",          # zero_grad at the step's start; all-reduce, clip, optimizer
    "pretrain.ema",             # the teacher's EMA update
    "predict.case",             # one a case (predict_sliding_window_return_logits)
    "predict.load_weights",     # a fold's weights into the network
    "predict.upload",           # padding, layout, the volume's copy, Gaussian, accumulators
    "predict.tiles",            # a tile batch cut and its flips stacked
    "predict.forward",          # the network on a tile batch
    "predict.merge",            # flips back, fp32 average, the Gaussian blend
    "predict.download",         # normalization, logits to the host, unpadding, fold average
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span while the profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF

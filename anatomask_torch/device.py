"""The device an entry point of the port runs on: CUDA unless the caller asks
for the CPU, where every kernel's plain PyTorch version runs instead; and the
compute dtype it runs in."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("anatomask_torch runs on CUDA by default and no CUDA device "
                           "is available; pass device='cpu' to run the plain versions")
    return device


def compute_dtype(dtype) -> torch.dtype:
    """The torch dtype of a compute dtype ("bfloat16", "float32" or a torch
    dtype). For float32 it turns TF32 off for cuDNN's convolutions and
    cuBLAS's matmuls (torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32, process-wide flags): PyTorch runs
    a float32 convolution in TF32 by default, about three decimal digits,
    where the port's kernels and the JAX package compute the library ops
    beside them (dw, the stride-2, 1x1 and transposed convs) in float32."""
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(dtype, dtype)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute dtype must be bfloat16 or float32, got {dtype!r}")
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dtype

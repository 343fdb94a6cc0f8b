"""The device an entry point of the port runs on: CUDA unless the caller asks
for the CPU, where every kernel's plain PyTorch version runs instead."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("anatomask_torch runs on CUDA by default and no CUDA device "
                           "is available; pass device='cpu' to run the plain versions")
    return device

"""Network construction from plans. Counterpart of anatomask_tpu/models/build.py
(the STUNet branch): 'STUNet-{S,B,L,H}' selects a STUNet preset whose pool and
conv kernel sizes come from the plans configuration."""
from __future__ import annotations

from typing import Optional

import torch

from anatomask_torch.models.stunet import STUNet, stunet_preset

_STUNET_SIZES = {"s": "small", "b": "base", "l": "large", "h": "huge"}


def build_network_from_plans(plans_manager, configuration_manager, num_input_channels: int,
                             num_output_channels: int, arch_name: Optional[str] = None,
                             deep_supervision: bool = True,
                             dtype: torch.dtype = torch.float32, device="cuda",
                             generator: Optional[torch.Generator] = None) -> STUNet:
    """arch_name overrides the plans' UNet_class_name. Weights are random from
    `generator` (default: seed 0); a checkpoint's replace them."""
    cm = configuration_manager
    name = arch_name or cm.UNet_class_name
    if not name.lower().startswith("stunet"):
        raise NotImplementedError(
            f"{name} is not ported to anatomask_torch yet: only STUNet is "
            "(PlainConvUNet and ResidualEncoderUNet are queued in ROADMAP.md)")
    preset = _STUNET_SIZES[name.split("-")[-1].lower()[0]]
    strides = [list(s) for s in cm.pool_op_kernel_sizes]
    kernels = [list(k) for k in cm.conv_kernel_sizes]
    # STUNet takes num_pool strides (without the leading unit stride) and is
    # fixed at 6 stages: the plans' topology is extended or cut to match
    pool_sizes = strides[1:] if all(s == 1 for s in strides[0]) else strides
    while len(pool_sizes) < 5:
        pool_sizes.append([1] * len(kernels[0]))
    pool_sizes = pool_sizes[:5]
    while len(kernels) < 6:
        kernels.append([3] * len(kernels[0]))
    kernels = kernels[:6]
    return stunet_preset(preset, num_input_channels, num_output_channels,
                         pool_op_kernel_sizes=pool_sizes, conv_kernel_sizes=kernels,
                         deep_supervision=deep_supervision, dtype=dtype, device=device,
                         generator=generator)

"""Network construction from plans. Counterpart of anatomask_tpu/models/build.py:
'STUNet-{S,B,L,H}' selects a STUNet preset whose pool and conv kernel sizes
come from the plans configuration; 'PlainConvUNet' (nnU-Net's default) and
'ResidualEncoderUNet' take the whole topology from it."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from anatomask_torch.device import resolve_device
from anatomask_torch.models.plain_unet import PlainConvUNet, ResidualEncoderUNet
from anatomask_torch.models.stunet import stunet_preset

_STUNET_SIZES = {"s": "small", "b": "base", "l": "large", "h": "huge"}


def build_network_from_plans(plans_manager, configuration_manager, num_input_channels: int,
                             num_output_channels: int, arch_name: Optional[str] = None,
                             deep_supervision: bool = True,
                             dtype: torch.dtype = torch.float32, device="cuda",
                             generator: Optional[torch.Generator] = None,
                             norm: str = "instance", remat: bool = False) -> nn.Module:
    """arch_name overrides the plans' UNet_class_name; norm ("instance" or
    "batch") is PlainConvUNet's; remat checkpoints activations (STUNet-H
    always). Weights are random from `generator` (default: seed 0); a
    checkpoint's replace them."""
    cm = configuration_manager
    name = arch_name or cm.UNet_class_name
    strides = [list(s) for s in cm.pool_op_kernel_sizes]
    kernels = [list(k) for k in cm.conv_kernel_sizes]
    n_stages = len(kernels)
    if name.lower().startswith("stunet"):
        preset = _STUNET_SIZES[name.split("-")[-1].lower()[0]]
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
                             generator=generator, remat=remat or None)

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    features = [min(cm.UNet_base_num_features * 2 ** i, cm.unet_max_num_features)
                for i in range(n_stages)]
    common = dict(input_channels=num_input_channels, num_classes=num_output_channels,
                  n_stages=n_stages, features_per_stage=features, kernel_sizes=kernels,
                  strides=strides, n_conv_per_stage_decoder=list(cm.n_conv_per_stage_decoder),
                  deep_supervision=deep_supervision, dtype=dtype, generator=generator,
                  remat=remat)
    if name == "ResidualEncoderUNet":
        net = ResidualEncoderUNet(n_blocks_per_stage=list(cm.n_conv_per_stage_encoder), **common)
    elif name == "PlainConvUNet":
        net = PlainConvUNet(n_conv_per_stage=list(cm.n_conv_per_stage_encoder), norm=norm,
                            **common)
    else:
        raise RuntimeError(f"Unknown network architecture {name!r}")
    return net.to(device)

"""elementwise_ms.train: device ms a step in PyTorch's own kernels
(elementwise, copies, reductions, the optimizer's foreach kernels)."""


def read(ctx):
    if ctx.unit != "step" or not ctx.trace.n_device_ops:
        return None
    return ctx.group_ms_per_unit("elementwise")

"""elementwise_ms.predict: device ms a case in PyTorch's own kernels
(elementwise, copies, reductions, the optimizer's foreach kernels)."""


def read(ctx):
    if ctx.unit != "case" or not ctx.trace.n_device_ops:
        return None
    return ctx.group_ms_per_unit("elementwise")

"""cudnn_ms.train: device ms a step in the libraries' kernels (cuDNN,
cuBLAS, CUTLASS): the strided, 1x1 and transposed convs, the weight
gradients, the matmuls."""


def read(ctx):
    if ctx.unit != "step" or not ctx.trace.n_device_ops:
        return None
    return ctx.group_ms_per_unit("library")

"""cudnn_ms.predict: device ms a case in the libraries' kernels (cuDNN,
cuBLAS, CUTLASS): the strided, 1x1 and transposed convs, the weight
gradients, the matmuls."""


def read(ctx):
    if ctx.unit != "case" or not ctx.trace.n_device_ops:
        return None
    return ctx.group_ms_per_unit("library")

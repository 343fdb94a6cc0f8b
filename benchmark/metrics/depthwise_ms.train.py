"""depthwise_ms.train: device ms a step in the kernels that run the depthwise
convs, forward, input gradient and weight gradient: those whose full
demangled name holds `depthwise` (PyTorch's `conv_depthwise3d_*` kernels;
any later kernel that runs these convs carries `depthwise` in its name), read
from the traced run's Chrome trace (`benchmark/named_kernels.py`). Nothing
where no such kernel ran."""
from benchmark import named_kernels


def read(ctx):
    if ctx.unit != "step":
        return None
    seconds = named_kernels.device_s(ctx.workload, "depthwise")
    return None if seconds is None else seconds * 1e3 / ctx.units

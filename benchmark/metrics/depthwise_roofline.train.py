"""depthwise_roofline.train: the yardstick's summed bound of the depthwise
convs' forwards, input gradients and weight gradients of the traced window's
steps (a launch: the larger of its FLOPs over the bf16 peak and its bytes,
input and output once, over the memory's), over the device seconds of the
kernels whose name holds `depthwise` (`depthwise_ms.train`'s). Nothing where
no such kernel ran or the configuration has no depthwise conv."""
from benchmark import named_kernels


def read(ctx):
    bound = getattr(ctx.work, "depthwise_bound_s", 0.0)
    if ctx.unit != "step" or not bound:
        return None
    seconds = named_kernels.device_s(ctx.workload, "depthwise")
    return None if seconds is None else 100.0 * bound * ctx.units / seconds

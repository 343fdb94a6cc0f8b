"""conv_roofline.train: the summed bound of the stride-1 3x3x3 convs'
forwards and input gradients of the traced window's steps (the yardstick's
count), over the device seconds the trace gives kernels #1 and #2. Nothing
where the program's launch count differs from the shapes' (the bound would
count other work) or the trace holds no such kernel."""


def read(ctx):
    seconds = ctx.trace.group_s.get("conv", 0.0)
    if (ctx.unit != "step" or seconds <= 0
            or ctx.conv_launches != ctx.work.conv_launches * ctx.units):
        return None
    return 100.0 * ctx.work.conv_bound_s * ctx.units / seconds

"""mfu.train: the model FLOPs of the traced window's steps (the yardstick's
count from the configuration's shapes) over its wall seconds, as a share of
the device's published bf16 tensor-core peak."""


def read(ctx):
    if ctx.unit != "step" or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.work.flops * ctx.units / ctx.trace.window_s / ctx.peak["bf16_flops"]

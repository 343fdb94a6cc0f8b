"""idle_share.predict: the share of the traced window's wall time in which no
kernel, copy or memset ran on the device (their union; the profiler's GPU
user annotations left out)."""


def read(ctx):
    if ctx.unit != "case" or not ctx.trace.n_device_ops or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

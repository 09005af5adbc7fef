"""device_idle: % of the traced window in which no operation ran on the
device (``torch.profiler``'s timeline: kernels, copies and sets)."""


def read(ctx):
    if ctx.device is None or ctx.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.device["busy_s"] / ctx.device["window_s"])

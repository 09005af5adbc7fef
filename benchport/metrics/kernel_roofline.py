"""kernel_roofline: % of the HBM bound that the device's kernels reach.

The bound: for each request wholly inside the traced window, its
distinct named rows over every slice read once at 3.35 TB/s (or its
word operations at the 32-bit rate, where that is longer:
``roofline.bound_s``).  The time: every kernel's time in the window from
``torch.profiler``.  Kernels of requests that straddle the window's
edges count and their bytes do not, so the share errs low."""

from benchport import roofline


def read(ctx):
    if ctx.device is None or ctx.device["kernel_s"] <= 0:
        return None
    n_slices = int(ctx.cfg["slices"])
    need = 0.0
    for r in ctx.requests:
        if r.ok and r.done <= ctx.t_end:
            need += roofline.bound_s(roofline.request_bytes(r.rows, n_slices),
                                     roofline.request_ops(r.rows, n_slices))[0]
    if need <= 0:
        return None
    return 100.0 * need / ctx.device["kernel_s"]

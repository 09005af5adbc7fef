"""The 95th percentile of the due-to-done times of every request due in
the window (host clock), in ms; read by ``metrics/p95_ms.host.py``."""

import numpy as np


def p95_ms(ctx):
    lat = [(r.done - r.due) * 1e3 for r in ctx.requests]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95.0))

"""p95_ms.host: the 95th percentile of every request's due-to-done time
in the window, in ms (host clock): the tail a dashboard user waits.  A
per-layer metric of the host, since the card idles most of each cell's
traced window."""

from benchport.latency import p95_ms


def read(ctx):
    return p95_ms(ctx)

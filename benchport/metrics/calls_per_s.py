"""calls_per_s: Count calls answered in the window per second, over all
clients: the calls of every request answered by the window's close,
over the window's seconds (host clock)."""


def read(ctx):
    return ctx.calls_answered() / ctx.seconds

"""launches_per_call: launches of the port's kernels in the window
(the delta of ``ops.kernels.LAUNCHES``, every kernel) per Count call
answered in it."""


def read(ctx):
    calls = ctx.calls_answered()
    if not calls:
        return None
    return sum(ctx.launches.values()) / calls

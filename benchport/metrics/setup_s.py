"""setup_s: process start to the window's opening (host clock): making
and loading the data, building or loading the kernels, filling the row
pool and the warm-up requests."""


def read(ctx):
    return ctx.setup_s

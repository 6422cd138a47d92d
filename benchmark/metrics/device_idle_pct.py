"""The traced window's share in which no kernel, copy or set ran on the
device, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])

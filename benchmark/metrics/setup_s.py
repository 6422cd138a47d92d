"""Seconds from the process's start to the first timed request: imports,
the kernel library's load (its build on a checkout's first run), weights,
traffic, the checked requests and the warm-up."""


def read(ctx):
    return ctx.setup_s

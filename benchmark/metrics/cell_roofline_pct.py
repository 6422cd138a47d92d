"""The cells layer's share of its roofline, in %: the least time of the
layer's work a request (``benchmark/work.py``) over its device time a
request in the trace (``benchmark/trace.py``, kernels by
``benchmark/kernels/cells/``)."""

from benchmark.trace import layer_share


def read(ctx):
    return layer_share(ctx, "cells")

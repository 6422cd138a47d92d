"""95th percentile over all requests of the window (host clock): a train
step from its launch until its losses are on the host, a streaming segment
from its first window's launch until its confusion matrix is."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx.window["latencies_s"], 95))

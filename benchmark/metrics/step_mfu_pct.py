"""The model operations of one request (the frozen rollout's convs and
ConvLSTM gates, the decode where the step decodes, the head's and for UDA
the image front's forward and backward; ``benchmark/work.py``), each over
the datasheet peak of its type, over the request's time in the window
(untraced), in %."""


def read(ctx):
    ops_s = sum(w.ops_seconds() for w in ctx.work.values())
    return 100.0 * ops_s / ctx.window["seconds_per_request"]

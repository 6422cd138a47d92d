"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()``, in GiB."""


def read(ctx):
    return ctx.window["peak_bytes"] / 2 ** 30

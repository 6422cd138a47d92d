"""Event windows completed in the window over its seconds (host clock):
steps x B x T for a train cell, segments x streams x windows for
streaming."""


def read(ctx):
    return ctx.window["windows"] / ctx.window["seconds"]

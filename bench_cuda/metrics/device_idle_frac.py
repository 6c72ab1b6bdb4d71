"""The device's idle share of the traced window: 1 - busy / window, overlapping events counted once."""


def read(ctx):
    busy = ctx.trace.busy_s()
    return 1.0 - busy / ctx.trace.window_s if busy > 0 else None

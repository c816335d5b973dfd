"""curves_per_s: phase + group curves returned by the window's
calls, over the window (host clock, each call ending in a device
synchronize)."""


def read(ctx):
    return ctx.work / ctx.window_s

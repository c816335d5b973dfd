"""samples_per_s: Metropolis samples (lanes x steps) the window
completed, over the window (host clock, each segment ending with its
rows on the host)."""


def read(ctx):
    return ctx.work / ctx.window_s

"""kernel_roofline.forward: the sum of every secular-lane launch's
least time on the H100 (harness/roofline.py, counted from each
launch's inputs) over the profiler device time of those kernels in the
traced window, in percent; against the published 700 W peaks."""


def read(ctx):
    if ctx.trace is None or ctx.roofline is None or not ctx.trace.secular_s:
        return None
    return 100.0 * ctx.roofline[1] / ctx.trace.secular_s

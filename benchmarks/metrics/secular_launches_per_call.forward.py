"""secular_launches_per_call.forward: the port's own launch counters
of the four secular-lane entry points, read before and after the
window, per call."""


def read(ctx):
    n = sum(ctx.launches.values())
    if not n:
        return None
    return n / len(ctx.units)

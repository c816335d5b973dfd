"""launches_per_step.survey: device kernels launched in the traced
window (profiler) per Metropolis step."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.launches / (ctx.work / ctx.lanes)

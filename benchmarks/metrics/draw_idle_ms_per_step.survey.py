"""draw_idle_ms_per_step.survey: the device-idle time of the traced
window that falls inside the program's ``pysurfinv.draw`` spans (the
retry rounds' key splits and draws), in ms per Metropolis step."""

from harness.program_spans import idle_in_spans_s


def read(ctx):
    s = idle_in_spans_s(ctx.trace, "pysurfinv.draw")
    if s is None:
        return None
    return 1e3 * s / (ctx.work / ctx.lanes)

"""solve_idle_ms_per_call.forward: the device-idle time of the traced
window that falls inside the program's ``pysurfinv.solve`` spans, in ms
per call: the solve's share of the idle time, as against the
benchmark's own work around it (in a traced run the roofline count of
each launch runs inside the solve and is part of it)."""

from harness.program_spans import idle_in_spans_s


def read(ctx):
    s = idle_in_spans_s(ctx.trace, "pysurfinv.solve")
    if s is None:
        return None
    return 1e3 * s / len(ctx.units)

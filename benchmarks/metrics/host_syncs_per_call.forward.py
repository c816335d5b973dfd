"""host_syncs_per_call.forward: host reads of a device value inside the
solve in the traced window (the program's ``host_syncs`` counter) per
``surf_forward_batch`` call."""

from harness.program_spans import counter


def read(ctx):
    n = counter("host_syncs")
    if ctx.trace is None or n is None:
        return None
    return n / len(ctx.units)

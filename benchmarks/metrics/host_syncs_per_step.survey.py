"""host_syncs_per_step.survey: host reads of a device value on the
program's path in the traced window (its ``host_syncs`` counter) per
Metropolis step."""

from harness.program_spans import counter


def read(ctx):
    n = counter("host_syncs")
    if ctx.trace is None or n is None:
        return None
    return n / (ctx.work / ctx.lanes)

"""prior_evals_per_sample.survey: proposals the prior judged in the
traced window (the program's ``propose.candidates`` counter) per
Metropolis sample the window completed: the retry loop's waste ratio."""

from harness.program_spans import counter


def read(ctx):
    n = counter("propose.candidates")
    if ctx.trace is None or n is None:
        return None
    return n / ctx.work

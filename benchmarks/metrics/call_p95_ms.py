"""call_p95_ms: the 95th percentile of the window's call times
(host clock, each up to a device synchronize), linear between ranks."""

import numpy as np


def read(ctx):
    if len(ctx.units) < 20:
        return None
    return float(np.percentile([(t1 - t0) * 1e3 for t0, t1, _ in ctx.units],
                               95))

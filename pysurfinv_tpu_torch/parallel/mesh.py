"""Devices for lane ranges: the counterpart of the JAX package's
``parallel/mesh.py``.

The JAX package shards the flat (point, chain) lane axis of
``invert_grid`` over a 1-D ``"points"`` mesh (``points_mesh``).  Here the
lanes split into contiguous ranges, one per entry of a device list, each
range run by a process of its own (``parallel.grid``); this module lists
the devices.  No collectives are needed: lanes never communicate.
"""

from __future__ import annotations


def points_devices(n=None):
    """The visible CUDA devices (the first ``n`` of them), as
    ``torch.device`` objects: the ``device=`` list of ``invert_grid`` /
    ``Point.MCinvMP`` that spreads the lanes over every card."""
    import torch

    count = torch.cuda.device_count()
    n = count if n is None else int(n)
    if not 1 <= n <= count:
        raise ValueError(f"points_devices: asked for {n} CUDA devices, "
                         f"{count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def lane_ranges(n_lanes, n_ranges):
    """Contiguous ``[lo, hi)`` lane ranges, one per device entry, sizes
    differing by at most one (the first ranges take the remainder); no
    range is empty and no lane is replicated."""
    n_ranges = min(int(n_ranges), int(n_lanes))
    base, extra = divmod(int(n_lanes), n_ranges)
    out, lo = [], 0
    for j in range(n_ranges):
        hi = lo + base + (j < extra)
        out.append((lo, hi))
        lo = hi
    return out

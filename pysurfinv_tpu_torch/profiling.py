"""Profiling and throughput instrumentation.

Counterpart of the JAX package's ``profiling.py``.  The reference's only
instrumentation is wall-clock prints per chain (``point.py:55,87,125``).
Here ``trace`` wraps ``torch.profiler`` with CUDA activity (a device
trace of the kernels, written as a Chrome trace), ``annotate`` names a
host region inside a trace, and ``throughput`` measures a rate the way
``chip_smoke.py`` does: best of ``windows`` timing windows, each closed
by ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass


@contextlib.contextmanager
def trace(logdir: str = "torch_trace", activities=None):
    """Device trace context; yields the ``torch.profiler.profile``.

    On exit the trace is written to ``<logdir>/trace.json`` (open it in
    Perfetto or chrome://tracing); ``prof.key_averages()`` gives the
    per-kernel device times.

    >>> with trace("build/tr") as prof:
    ...     surf_forward_batch(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    if activities is None:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named host region inside an active trace (``record_function``)."""
    import torch

    return torch.profiler.record_function(name)


@dataclass
class Throughput:
    """Result of :func:`throughput`."""

    value: float          # units/second (best window)
    unit: str
    best_s: float         # best window seconds per call
    windows_s: list[float] = None  # all window timings

    def __str__(self):
        return f"{self.value:,.1f} {self.unit}/s (best {self.best_s:.4f} s)"


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def throughput(fn, n_units: int, unit: str = "solves", iters: int = 2,
               windows: int = 3) -> Throughput:
    """Best-window throughput of ``fn``.

    Warms up once, then times ``windows`` windows of ``iters`` calls
    each, every window closed by ``torch.cuda.synchronize()`` (kernel
    launches are asynchronous), and reports the best window.
    """
    fn()
    _sync()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync()
        times.append((time.perf_counter() - t0) / iters)
    best = min(times)
    return Throughput(value=n_units / best, unit=unit, best_s=best,
                      windows_s=times)

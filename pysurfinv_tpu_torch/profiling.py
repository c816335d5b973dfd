"""Tracing of the port: spans and counters inside the program, on
torch.profiler.

Counterpart of the JAX package's ``profiling.py``.  The reference's only
instrumentation is wall-clock prints per chain (``point.py:55,87,125``).
Here ``trace`` wraps ``torch.profiler`` with CUDA activity (a device
trace of the kernels, written as a Chrome trace); ``annotate`` names a
host region (a span) inside it, on the profiler's clock, so each idle
gap of the device can be put down to what the host was doing; ``count``
adds to a counter, and ``counters`` reads every counter and the secular
kernels' launch counts at once.

The spans record while a torch.profiler session records (its
process-wide flag, which every thread sees); the counters count then
and inside :func:`counting` as well.  Otherwise a span site costs one
flag read and a shared no-op context, and a counter site one or two
flag reads: nothing calls ``record_function``, reads a clock or touches
the device.

The spans (``pysurfinv.*``) and counters the program sets, and where:

  * ``pysurfinv.segment`` (``inversion/mcmc.py``, one sampler segment),
    inside it ``pysurfinv.propose`` (the prior-accepted
    proposals of one step), inside that ``pysurfinv.draw`` (one retry
    round's key splits and draws), ``pysurfinv.prior`` (one round's
    prior, profile build included) and ``pysurfinv.compact`` (the retry
    pyramid's compaction between stages); ``pysurfinv.likelihood`` (the
    lanes' solve and misfit of a posterior step);
  * ``pysurfinv.solve`` (``ops/dispersion.py``, one
    ``surf_forward_batch`` call), inside it ``pysurfinv.solve.bracket``
    (warm or cold; the cold chain's ``pysurfinv.solve.rescue`` inside
    it), ``pysurfinv.solve.refine`` and ``pysurfinv.solve.group``;
  * ``pysurfinv.store``, ``pysurfinv.checkpoint`` and ``pysurfinv.write``
    (``parallel/grid.py``: a segment's rows and carry to the host, and
    the rows into the track buffer and the compressor; the checkpoint
    write; the chain files);
  * counters: ``propose.candidates`` (candidates the prior judged),
    ``draw.kernel_rounds`` / ``draw.plain_rounds`` (retry rounds drawn
    by the CUDA kernel / by torch ops: one a ``pysurfinv.draw`` span),
    ``host_syncs`` (host reads of a device value on the sampler's and
    the solve's path), ``compress.busy_s`` (the streamed compressor's
    worker-thread CPU seconds),
    ``solve.warm_fallbacks`` (calls whose warm window missed a lane) and
    ``solve.rescues`` (calls that ran the rescue pass).
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch
from torch.autograd import profiler as _prof

_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_registry: dict = {}
_counting = 0      # depth of counting() contexts, process-wide


@contextlib.contextmanager
def trace(logdir: str = "torch_trace", activities=None):
    """Device trace context; yields the ``torch.profiler.profile``.

    On exit the trace is written to ``<logdir>/trace.json`` (open it in
    Perfetto or chrome://tracing); ``prof.key_averages()`` gives the
    per-kernel device times.  The program's spans record and its
    counters count inside it.

    >>> with trace("build/tr") as prof:
    ...     surf_forward_batch(...)
    """
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
    """A named host span (``record_function``) while a profiler records,
    the shared no-op context otherwise.  Its parent is the span around
    it on the same thread."""
    if _prof._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


def enabled() -> bool:
    """Whether the counters count: a profiler records, or a
    :func:`counting` context is open."""
    return bool(_counting or _prof._is_profiler_enabled)


def count(name: str, n=1):
    """Add the host number ``n`` to counter ``name`` while the counters
    count (:func:`enabled`)."""
    if _counting or _prof._is_profiler_enabled:
        with _lock:
            _registry[name] = _registry.get(name, 0) + n


def counters() -> dict:
    """A snapshot of every counter, and ``kernel.<name>``: the launches
    of each secular-lane and draw entry point
    (``ops.secular_lanes.KERNELS``, ``ops.draw_lanes.KERNELS``)."""
    from pysurfinv_tpu_torch.ops import draw_lanes, secular_lanes
    with _lock:
        out = dict(_registry)
    out.update({f"kernel.{k.__name__}": k.launches
                for k in secular_lanes.KERNELS + draw_lanes.KERNELS})
    return out


def reset_counters():
    """Clear the counters (the kernels' launch counts stay)."""
    with _lock:
        _registry.clear()


@contextlib.contextmanager
def counting(on: bool = True):
    """Turn the counters on without a profiler (a no-op unless ``on``);
    the spans stay off."""
    global _counting
    n = int(bool(on))
    with _lock:
        _counting += n
    try:
        yield
    finally:
        with _lock:
            _counting -= n

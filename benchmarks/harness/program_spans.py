"""What the program itself records in a traced window: its spans
(``pysurfinv.*`` host events of the window thread, set by the port's
``profiling.annotate``) and its counters (``profiling.counters()``,
which count only while the profiler records, so in a traced run they
hold the window and nothing else).  A program without them (one that
predates its spans and counters) gives nothing to read: every function
here then returns None."""

from __future__ import annotations

from harness.tracing import _union


def counter(name):
    """The program's counter ``name``, or None where the program has no
    counters or never counted it."""
    from pysurfinv_tpu_torch import profiling
    read = getattr(profiling, "counters", None)
    if read is None:
        return None
    return read().get(name)


def span_intervals(trace, name):
    """[(t0, t1)] (µs) of the window thread's spans called ``name``,
    merged where they overlap; None where the trace holds none."""
    if trace is None:
        return None
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in trace._ops
             if e.get("name") == name]
    return _union(spans) if spans else None


def idle_in_spans_s(trace, name):
    """Seconds of the traced window in which the device was idle while
    the host was inside a span called ``name``; None where the trace
    holds no such span."""
    spans = span_intervals(trace, name)
    if spans is None:
        return None
    total, j = 0.0, 0
    for a, b in trace.idle_gaps():
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            total += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return total * 1e-6

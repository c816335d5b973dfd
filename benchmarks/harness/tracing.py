"""The traced run: torch.profiler (CPU and CUDA activity) over the traced
window, its Chrome trace written under the temporary directory, and the
reduction of that trace to what the per-layer metrics and the breakdown
read: the device's busy timeline, kernel launches and times by name,
and the idle gaps by what the host was running."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from contextlib import contextmanager

WINDOW_SPAN = "bench.window"
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
# the symbols of the port's secular-lane kernels (refine_lanes launches
# its two phase kernels)
SECULAR_SYMBOLS = ("secular_lanes_kernel", "secular_frozen_kernel",
                   "secular_grad_kernel", "refine_illinois_kernel",
                   "refine_newton_kernel")


@contextmanager
def span(name):
    """A host span of the benchmark's own, around a call into a layer."""
    import torch
    with torch.profiler.record_function(name):
        yield


class Trace:
    """What the harness reads off one traced window."""

    def __init__(self, events, path=None):
        self.path = path
        win = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the trace holds no window span")
        w = win[0]
        self.w0, self.w1 = w["ts"], w["ts"] + w["dur"]
        tid = w.get("tid")
        inside = lambda e: self.w0 <= e["ts"] <= self.w1  # noqa: E731
        gpu = sorted((e for e in events if e.get("ph") == "X"
                      and e.get("cat") in GPU_CATS and inside(e)),
                     key=lambda e: e["ts"])
        self.kernels = [e for e in gpu if e["cat"] == "kernel"]
        self.launches = len(self.kernels)
        self.window_s = (self.w1 - self.w0) * 1e-6
        self.busy = _union([(e["ts"], min(e["ts"] + e["dur"], self.w1))
                            for e in gpu])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        by_name = {}
        for e in self.kernels:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
        self.device_s_by_name = by_name
        self.secular_s = sum(s for n, s in by_name.items()
                             if any(k in n for k in SECULAR_SYMBOLS))
        self.secular_launches = sum(
            1 for e in self.kernels
            if any(k in e["name"] for k in SECULAR_SYMBOLS))
        host = [e for e in events if e.get("ph") == "X"
                and e.get("cat") in HOST_CATS and e.get("tid") == tid
                and e["ts"] + e.get("dur", 0) >= self.w0
                and e["ts"] <= self.w1 and e.get("name") != WINDOW_SPAN]
        spans = sorted((e for e in host if e["name"].startswith("bench.")),
                       key=lambda e: e["ts"])
        ops = sorted((e for e in host if not e["name"].startswith("bench.")),
                     key=lambda e: e["ts"])
        self._spans, self._span_ts = spans, [e["ts"] for e in spans]
        self._ops, self._op_ts = ops, [e["ts"] for e in ops]

    def idle_gaps(self):
        """[(t0, t1)] of the window not covered by device work (µs)."""
        gaps, t = [], self.w0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        return gaps

    def host_at(self, t):
        """'span/op': the benchmark span and the innermost host op
        running at time t (µs); either part alone where the other is
        missing, 'host' where neither runs."""
        def innermost(evs, ts, depth):
            i = bisect.bisect_right(ts, t) - 1
            for j in range(i, max(i - depth, -1), -1):
                if evs[j]["ts"] + evs[j].get("dur", 0) >= t:
                    return evs[j]["name"]
            return None

        names = [n for n in (innermost(self._spans, self._span_ts, 64),
                             innermost(self._ops, self._op_ts, 64)) if n]
        return "/".join(names) or "host"

    def breakdown(self, top=10):
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        idle = {}
        for a, b in self.idle_gaps():
            k = self.host_at(0.5 * (a + b))
            idle[k] = idle.get(k, 0.0) + (b - a) * 1e-6
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:120], s] for n, s in ops[:top]],
                "idle_gaps": [[n[:120], s] for n, s in gaps[:top]]}


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Tracer:
    """Profile the traced window; :meth:`read` writes the Chrome trace
    under the temporary directory and reduces it."""

    def __init__(self, name):
        self.path = os.path.join(tempfile.gettempdir(),
                                 f"benchmark_{name}.trace.json")
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def read(self):
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        return Trace(events, self.path)

#!/usr/bin/env python3
"""One run of one cell of the benchmark of pysurfinv_tpu_torch.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix;
the traffic names the entry that drives the window.  Set-up builds the
entry's inputs from the seed and warms every shape it uses; the window
then runs units of work (a sampler segment, a solve call, a curve) until
``--seconds`` have passed, ending with the unit running at that moment.
With ``--trace 0`` the last line of standard output is the result with
the cell's end-to-end metrics; with ``--trace 1`` a window of the
traffic's ``trace_units`` units runs under torch.profiler (its Chrome
trace left in the temporary directory) and the line carries the cell's
per-layer metrics and a breakdown of device and idle time.  Either way,
once the window has closed and the program's state is freed, the plain
reference judges a sample of what the window produced; the numbers
compared and their limits end standard error and the result line.

The run needs CUDA and as many cards as the cell asks for; without them
it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

# top-level modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "pysurfinv_tpu")


def since_boot():
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start():
    """When this process started, in seconds since boot."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


class Context:
    """What the metric readers read: the window's units, the set-up
    time, the trace (traced runs), the kernel launch counts and the
    roofline counts of the window."""

    def __init__(self, entry, units, setup_s, launches, trace=None,
                 roofline=None):
        self.unit_name = entry.unit_name
        self.lanes = getattr(entry, "n", None)
        self.units = units                       # [(t0, t1, work)]
        self.work = sum(w for _, _, w in units)
        self.window_s = units[-1][1] - units[0][0]
        self.setup_s = setup_s
        self.launches = launches                 # kernel name -> count
        self.trace = trace
        self.roofline = roofline                 # (ops, bound seconds)


def card_line():
    """The card's name, clocks and power, as nvidia-smi reads them."""
    q = "name,clocks.sm,clocks.max.sm,power.limit,power.draw,temperature.gpu"
    try:
        res = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    return dict(zip(q.split(","), (x.strip() for x in
                                   res.stdout.splitlines()[0].split(","))))


def window(step, seconds, clock=since_boot):
    """Run ``step`` (-> work done) until ``seconds`` have passed; the
    window ends with the step running at the deadline.  Returns the
    units as (start, end, work)."""
    units = []
    deadline = clock() + seconds
    while not units or units[-1][1] < deadline:
        t0 = clock()
        work = step()
        units.append((t0, clock(), work))
    return units


def run_cell(cell, seed, seconds, trace, device, start):
    """Set up, run the window, judge.  Returns the result line's dict,
    the checks [(name, value, limit)] and the metrics' context."""
    import torch

    from harness import roofline as RL
    from harness.cells import load_module
    from harness.tracing import WINDOW_SPAN, Tracer, span
    from pysurfinv_tpu_torch.ops import dispersion
    from pysurfinv_tpu_torch.ops import secular_lanes as sl

    entry = cell.entry().Entry(cell.config, cell.traffic, seed, device)
    counts = lambda: {k.__name__: k.launches for k in sl.KERNELS}  # noqa
    before = counts()
    units, tr, rl = [], None, None
    if trace:
        launches = RL.Launches()
        tracer = Tracer(cell.name)
        with launches.instrument(dispersion), tracer:
            with span(WINDOW_SPAN):
                setup_s = since_boot() - start
                for _ in range(int(cell.traffic["trace_units"])):
                    t0 = since_boot()
                    work = entry.step()
                    units.append((t0, since_boot(), work))
        tr = tracer.read()
        rl = launches.totals()
    else:
        setup_s = since_boot() - start
        units = window(entry.step, seconds)
    after = counts()
    ctx = Context(entry, units, setup_s,
                  {k: after[k] - before[k] for k in after}, tr, rl)
    on_cuda = str(device).startswith("cuda")
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    out = entry.outputs()
    failed = entry.failed(out)
    entry.close()
    del entry
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    judge = load_module(cell.bench_dir, "judges", cell.traffic["entry"])
    t_judge = since_boot()
    checks = judge.judge(cell, out, seed, device)
    ctx.judge_s = since_boot() - t_judge
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": int(ctx.work), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks, ctx


def main(argv=None):
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.cells import Cell
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks, ctx = run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), "cuda", start)
    held = sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
    if held:
        print(f"benchmark: the process holds {held}", file=sys.stderr)
        return 3
    print(json.dumps({"card": card_line(), "window_s": ctx.window_s,
                      "units": len(ctx.units), "unit": ctx.unit_name,
                      "kernel_launches": ctx.launches,
                      "judge_s": ctx.judge_s,
                      "trace": ctx.trace.path if ctx.trace else None}),
          flush=True)
    print(json.dumps(result), flush=True)
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings of a cell's correctness numbers, for setting their limits.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 5]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` at the cell's own load, then the judge twice over what the
window produced: once as the benchmark run judges it (the lower
reading), once with the control in the program's place (the reference,
or the program's own path, in the precision below the configuration's:
the upper reading).  One JSON line a seed.  The benchmark's own runs do
not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

import run as R


def readings(cell, seed, seconds, device):
    from harness.cells import load_module

    entry = cell.entry().Entry(cell.config, cell.traffic, seed, device)
    n = len(R.window(entry.step, seconds))
    out = entry.outputs()
    entry.close()
    judge = load_module(cell.bench_dir, "judges", cell.traffic["entry"])
    prog = judge.judge(cell, out, seed, device)
    ctl = judge.judge(cell, out, seed, device, control=True)
    return {"seed": seed, "units": n,
            "program": {k: v for k, v, _ in prog},
            "control": {k: v for k, v, _ in ctl},
            "limits": {k: lim for k, _, lim in prog}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    from harness.cells import Cell
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), args.seconds, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

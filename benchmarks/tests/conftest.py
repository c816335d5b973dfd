"""Shared set-up of the benchmark's CPU tests: the harness and the
program on the import path, and tiny copies of the benchmark (the same
files with smaller traffic and grids) that a CPU run can hold."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# sizes a CPU run holds: 2 x 2 grid points x 2 chains, 2-step segments;
# 8-model batches
TINY_TRAFFIC = {
    "survey_posterior": {"chains": 2, "check_rows": 6, "check_starts": 2,
                         "segment": 2, "window_from_step": 4},
    "survey_priori": {"chains": 2, "check_rows": 8, "check_starts": 2,
                      "segment": 2},
    "forward_batch": {"batch": 8, "n_batches": 2, "check_curves": 6,
                      "trace_units": 1},
}
TINY_POINTS = 4

# the posterior survey cell is out of BENCHMARK.json while the program's
# warm-started solve misses roots deep in the chains (PERF.md); its
# traffic, the judge's Metropolis branch and their checks stay, tested
# here, for its return
POSTERIOR_CELL = {"name": "survey.ocean.posterior",
                  "config": "cascadia_ocean_survey",
                  "traffic": "survey_posterior", "chips": 1,
                  "why": "the survey sampler with a solve every step"}


def make_tiny(dest, traffic=TINY_TRAFFIC, points=TINY_POINTS):
    """A copy of BENCHMARK.json (with the posterior survey cell) and
    benchmarks/ under ``dest`` with the tiny sizes; returns (bench_json,
    bench_dir)."""
    bdir = os.path.join(dest, "benchmarks")
    shutil.copytree(BENCH, bdir, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["workloads"].append(POSTERIOR_CELL)
    for m in spec["end_to_end"]:
        if m["name"] == "samples_per_s":
            m["workloads"].append(POSTERIOR_CELL["name"])
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    for name, patch in traffic.items():
        f = os.path.join(bdir, "traffic", name + ".json")
        with open(f) as fh:
            d = json.load(fh)
        d.update(patch)
        with open(f, "w") as fh:
            json.dump(d, fh)
    f = os.path.join(bdir, "configs", "cascadia_ocean_survey.json")
    with open(f) as fh:
        d = json.load(fh)
    d["assumed"]["grid"]["points"] = points
    with open(f, "w") as fh:
        json.dump(d, fh)
    return os.path.join(dest, "BENCHMARK.json"), bdir


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny_bench")))


def tiny_cell(tiny, name):
    from harness.cells import Cell
    return Cell(name, bench_json=tiny[0], bench_dir=tiny[1])

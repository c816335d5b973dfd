"""Find a cell's pieces by the names in ``BENCHMARK.json``: its
configuration file, its traffic file (``traffic/<traffic>.json``, which
names the entry that drives the window), the entry's driver
(``entries/<entry>.py``) and judge (``judges/<entry>.py``), and a
reader for each metric (``metrics/<metric>.py``).  A cell, a mix or a
metric is added by adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and metrics resolved.  ``bench_dir`` is the folder that holds
    ``configs/``, ``traffic/``, ``entries/`` and ``metrics/``."""

    def __init__(self, name, bench_json=None, bench_dir=BENCH_DIR):
        bench_json = bench_json or os.path.join(ROOT, "BENCHMARK.json")
        with open(bench_json) as f:
            spec = json.load(f)
        root = os.path.dirname(os.path.abspath(bench_json))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the cells are "
                             f"{sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.bench_dir = bench_dir
        conf = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config_name = conf["name"]
        with open(os.path.join(root, conf["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(bench_dir, "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.chips = int(self.workload["chips"])
        self.run_seconds = spec["run_seconds"]
        pick = lambda m: name in m.get("workloads", [name])  # noqa: E731
        self.end_to_end = [m for m in spec["end_to_end"] if pick(m)]
        self.per_layer = [m for m in spec["per_layer"] if pick(m)]

    def entry(self):
        """The entry driver module named by the traffic file."""
        return load_module(self.bench_dir, "entries", self.traffic["entry"])

    def reader(self, metric):
        return load_module(self.bench_dir, "metrics", metric).read


def load_module(bench_dir, kind, name):
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

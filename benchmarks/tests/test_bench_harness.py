"""The harness on the CPU: traffic from the seed, the window rule, the
metric arithmetic on a recorded synthetic trace, the roofline count of a
hand-worked launch, the result line's schema, and a cell, a mix and a
metric added by files alone."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, make_tiny, tiny_cell

import run as R
from harness import roofline as RL
from harness.cells import Cell
from harness.tracing import Trace


def test_benchmark_json_names_files_that_exist():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        cell = Cell(w["name"])
        assert os.path.exists(os.path.join(
            BENCH, "entries", cell.traffic["entry"] + ".py"))
        assert os.path.exists(os.path.join(
            BENCH, "judges", cell.traffic["entry"] + ".py"))
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]))
        assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
        assert cell.per_layer


def test_traffic_is_the_same_for_the_same_seed():
    """Every seed runs the same grid points, in an order the seed draws;
    the same seed, the same order."""
    from entries.survey import grid_locals
    cell = Cell("survey.ocean.priori")
    big = 3 * 2 ** 31 + 17
    a, b, c = (grid_locals(cell.config, s) for s in (big, big, big + 1))
    assert a == b and a != c and len(a) == 64
    key = lambda locs: sorted((x["sedthk"], x["lithoAge"])  # noqa: E731
                              for x in locs)
    assert key(a) == key(c)
    assert len({x["sedthk"] for x in a}) == len({x["lithoAge"] for x in a}) \
        == 8


def test_batches_are_the_same_for_the_same_seed(tiny):
    from entries.forward_batch import batches
    cell = tiny_cell(tiny, "forward.ocean.batch")
    a, na = batches(cell.config, cell.traffic, 2 ** 33 + 5, "cpu")
    b, nb = batches(cell.config, cell.traffic, 2 ** 33 + 5, "cpu")
    c, _ = batches(cell.config, cell.traffic, 2 ** 33 + 6, "cpu")
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][2], c[0][2])
    assert torch.equal(na, nb) and int(na[0]) == 86
    # +-0.5% on Vs and Vp of the layers (not the pads), one draw for both
    solid = a[0][2] > 0
    ratio = a[0][2][solid] / a[1][2][solid]
    assert 0 < float((ratio - 1).abs().max()) < 0.05
    np.testing.assert_allclose((a[0][1] / a[1][1])[solid], ratio, rtol=1e-6)
    assert torch.equal(a[0][2][:, 87], a[1][2][:, 87])


def test_window_ends_with_the_unit_running_at_the_deadline():
    t = [0.0]
    clock = lambda: t[0]  # noqa: E731

    def step():
        t[0] += 3.0
        return 7

    units = R.window(step, 10.0, clock)
    # units end at 3, 6, 9, 12: the one running at t = 10 counts
    assert [u[1] for u in units] == [3.0, 6.0, 9.0, 12.0]
    assert sum(u[2] for u in units) == 28


def _synthetic_trace():
    """A 1,000 µs window: kernels at [100, 200], [150, 300] (overlap),
    [500, 600] and a copy at [900, 950]; host ops and benchmark spans on
    the window's thread."""
    k = lambda n, ts, dur: {"ph": "X", "cat": "kernel", "name": n,  # noqa
                            "ts": ts, "dur": dur, "pid": 0, "tid": 7}
    h = lambda n, ts, dur, cat="cpu_op": {"ph": "X", "cat": cat,  # noqa
                                          "name": n, "ts": ts, "dur": dur,
                                          "pid": 1, "tid": 1}
    return [h("bench.window", 0.0, 1000.0, "user_annotation"),
            h("bench.segment", 0.0, 800.0, "user_annotation"),
            h("aten::argsort", 300.0, 200.0),
            k("void secular_lanes_kernel<true>(...)", 100.0, 100.0),
            k("elementwise", 150.0, 150.0),
            k("secular_grad_kernel<true>", 500.0, 100.0),
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
             "ts": 900.0, "dur": 50.0, "pid": 0, "tid": 8},
            k("outside", 1200.0, 10.0)]


def test_metric_arithmetic_on_a_recorded_trace():
    tr = Trace(_synthetic_trace())
    # busy: [100, 300] + [500, 600] + [900, 950] = 350 µs of 1,000
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(350e-6)
    assert tr.launches == 3
    assert tr.secular_s == pytest.approx(200e-6)
    gaps = tr.idle_gaps()
    assert gaps == [(0.0, 100.0), (300.0, 500.0), (600.0, 900.0),
                    (950.0, 1000.0)]
    b = tr.breakdown()
    idle = dict(b["idle_gaps"])
    assert idle["bench.segment/aten::argsort"] == pytest.approx(200e-6)
    assert idle["bench.segment"] == pytest.approx(400e-6)
    assert idle["host"] == pytest.approx(50e-6)
    assert b["device_ops"][0][1] == pytest.approx(150e-6)

    class E:
        unit_name, n = "segment", 4

    units = [(0.0, 0.5, 40), (0.5, 1.0, 40)]
    ctx = R.Context(E(), units, 12.5, {"secular_lanes": 3}, tr)
    read = lambda m: Cell("survey.ocean.priori").reader(m)(ctx)  # noqa
    assert read("idle_share.survey") == pytest.approx(65.0)
    assert read("launches_per_step.survey") == pytest.approx(3 / 20)
    assert read("samples_per_s") == pytest.approx(80.0)
    assert read("setup_s") == 12.5
    # a reader with nothing to read (no launches counted from their
    # inputs) returns nothing
    assert read("kernel_roofline.forward") is None
    assert read("mfu.forward") is None


def test_call_p95_and_rates():
    class E:
        unit_name = "call"

    ms = np.arange(1, 101, dtype=float)            # calls of 1..100 ms
    t, units = 0.0, []
    for d in ms:
        units.append((t, t + d / 1e3, 65536))
        t += d / 1e3
    ctx = R.Context(E(), units, 1.0, {"secular_lanes": 200})
    read = lambda m: Cell("forward.ocean.batch").reader(m)(ctx)  # noqa
    assert read("call_p95_ms") == pytest.approx(np.percentile(ms, 95))
    assert read("curves_per_s") == pytest.approx(100 * 65536 / (ms.sum() / 1e3))
    assert read("secular_launches_per_call.forward") == pytest.approx(2.0)


def test_roofline_count_of_a_hand_worked_launch():
    # secular_lanes_frozen, Rayleigh, K=2 periods x B=3 models, L=4:
    # applied layer steps 5 -> 5 * 182 operations; bytes: 7 model arrays
    # of 4 x 3 floats + 4 lane arrays of 2 x 3 floats
    ops, nbytes = RL.launch_work("secular_lanes_frozen", "rayleigh", 2, 3,
                                 4, 5)
    assert ops == 5 * 182
    assert nbytes == (7 * 4 * 3 + 4 * 2 * 3) * 4
    # the dynamic sweep adds the walk; a dual evaluation counts 4x
    assert RL.launch_work("secular_lanes", "love", 1, 1, 1, 1)[0] == 41 + 15
    assert RL.launch_work("secular_lanes_grad", "rayleigh", 1, 1, 1, 1)[0] \
        == 4 * 182
    assert RL.launch_work("refine_lanes", "rayleigh", 1, 1, 1, 1, n_ill=8,
                          n_newton=2)[0] == (8 + 2 + 2 * 4) * 182
    # 10 * 182 operations at 67 TFLOP/s against 184 bytes at 3.35 TB/s
    assert RL.bound_s(10 * 182, 184) == pytest.approx(184 / 3.35e12)
    assert RL.bound_s(1e9, 184) == pytest.approx(1e9 / 67e12)


def test_launches_are_counted_from_the_inputs():
    import types
    seen = []
    fake = types.SimpleNamespace(**{
        n: (lambda *a, n=n, **k: seen.append(n)) for n in RL.ENTRY_POINTS})
    launches = RL.Launches()
    mm = torch.tensor([[3, 1], [4, 9]], dtype=torch.int32)
    model = torch.zeros(5, 2)
    with launches.instrument(fake):
        fake.secular_lanes_frozen(torch.zeros(2, 2), None, mm,
                                  *([model] * 7), wave="rayleigh")
    assert seen == ["secular_lanes_frozen"]
    name, wave, K, B, L, applied, _, _ = launches.calls[0]
    # mm - 1 clamped to [0, L - 1]: 2 + 0 + 3 + 4
    assert (name, K, B, L, int(applied)) == ("secular_lanes_frozen", 2, 2,
                                             5, 9)
    ops, bound = launches.totals()
    assert ops == 9 * 182


def test_result_line_schema_and_a_file_only_cell(tmp_path):
    """A cell, a traffic mix and a metric added as files (no code edit)
    are found by name, and a CPU run of it gives the result line's
    keys."""
    bench_json, bdir = make_tiny(str(tmp_path))
    with open(os.path.join(bdir, "traffic", "forward_tiny.json"), "w") as f:
        json.dump({"entry": "forward_batch", "batch": 4, "n_batches": 1,
                   "jitter": 0.005, "wave": "rayleigh", "check_curves": 3,
                   "group_off_kms": 0.02, "trace_units": 1,
                   "limits": {"phase_gap": 1e-3, "group_off_lanes": 0,
                              "group_gap_p99": 1e-2,
                              "ok_mismatch": 0}}, f)
    with open(os.path.join(bdir, "metrics", "curves_total.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.work)\n")
    with open(bench_json) as f:
        spec = json.load(f)
    spec["workloads"].append({"name": "forward.ocean.tiny",
                              "config": "cascadia_ocean_forward",
                              "traffic": "forward_tiny", "chips": 1,
                              "why": "a throwaway cell"})
    spec["end_to_end"].append({"name": "curves_total", "unit": "curves",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["forward.ocean.tiny"]})
    with open(bench_json, "w") as f:
        json.dump(spec, f)
    cell = Cell("forward.ocean.tiny", bench_json=bench_json, bench_dir=bdir)
    res, checks, _ = R.run_cell(cell, 2 ** 32 + 3, 0.1, False, "cpu",
                                R.process_start())
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["metrics"]["curves_total"]["value"] == res["attempted"] == 4
    # metrics with a workloads list report only in the cells they name
    assert set(res["metrics"]) == {"curves_total", "setup_s"}
    assert res["correct"] is True and res["failed"] == 0
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    json.dumps(res)


def test_without_a_card_the_run_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "forward.ocean.batch", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_alone_the_benchmark_folder_does_not_run(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        "forward.ocean.batch", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "forward.ocean.batch", "--seed",
                        str(2 ** 31 + 11), "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"

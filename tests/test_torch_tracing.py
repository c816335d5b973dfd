"""The port's spans and counters (``pysurfinv_tpu_torch.profiling``) on
the CPU, at tiny sizes.

* With tracing off, a sampler segment and a batch solve never enter
  ``record_function`` and move no counter; with the counters alone on
  (``profiling.counting()``) they count and still enter no span.
* Under ``profiling.trace`` the named spans land in the Chrome trace,
  nested as the program nests them, and ``host_syncs`` counts every
  host read of a device value the trace records.
* ``propose.candidates`` counts the rows the prior judged.
* ``draw.plain_rounds`` counts the ``pysurfinv.draw`` spans of a CPU
  segment; on the card (a ``cuda``-marked test) ``draw.kernel_rounds``
  and the round kernel's launches count them.
* ``prior.plain_calls`` counts the ``pysurfinv.prior`` spans of a CPU
  segment; on the card ``prior.graph_captures`` counts one capture a
  batch shape and ``prior.graph_replays`` every prior call.
* The tracks are bitwise the same with tracing on and off.
* ``invert_grid(stats=)`` returns the counters of the call.
"""

import json

import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS
from torch_helpers import eus_batch, load_eus_model

from pysurfinv_tpu_torch import profiling
from pysurfinv_tpu_torch.convert import (model_batch_from_numpy,
                                         spec_from_numpy)
from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.inversion.compiled import (BrownianSpec,
                                                    CompiledModel)
from pysurfinv_tpu_torch.inversion import mcmc
from pysurfinv_tpu_torch.inversion.mcmc import (ChainConfig,
                                                make_segmented_sampler)
from pysurfinv_tpu_torch.inversion.point import PointCascadia
from pysurfinv_tpu_torch.ops import draw_lanes as DL
from pysurfinv_tpu_torch.ops.dispersion import surf_forward_batch
from pysurfinv_tpu_torch.parallel.grid import invert_grid

torch.set_num_threads(1)

SEDS = (0.019, 0.5)          # 2 points
NCH = 2                      # x 2 chains
SUB = slice(0, 18, 8)        # 10, 26 and 70 s


@pytest.fixture(scope="module")
def priori():
    """The lanes of a 2-point x 2-chain prior sampler: (cm, lanes), with
    ``lanes`` = (keys, spec_b, ctx_b, theta0, use_init)."""
    cm = CompiledModel(PointCascadia(SETTING, LOCAL, periods=PERIODS,
                                     vels=VELS, uncers=UNCERS).initMod)
    mods = [PointCascadia(SETTING, dict(LOCAL, sedthk=s), periods=PERIODS,
                          vels=VELS, uncers=UNCERS).initMod for s in SEDS]
    specs = [cm.spec_of(m) for m in mods]
    spec = tuple(np.repeat(np.stack([getattr(s, f) for s in specs]), NCH, 0)
                 for f in BrownianSpec._fields)
    psi = np.repeat(np.stack([cm.psi_of(m) for m in mods]), NCH, 0)
    spec_b, psi_b = spec_from_numpy(spec, psi, device="cpu")
    n = len(SEDS) * NCH
    keys = R.fold_in(R.PRNGKey(21), torch.arange(n))
    use_init = torch.tensor([True, False] * len(SEDS))
    return cm, (keys, spec_b, (psi_b,), spec_b.theta0, use_init)


def _sampler(cm, isgood=None):
    def no_solve(*_):
        raise AssertionError("prior mode evaluates no likelihood")

    isgood = isgood or (lambda t, ctx: cm.isgood(t, ctx[0]))
    return make_segmented_sampler(isgood, no_solve,
                                  ChainConfig(chain_len=8, priori=True))


def _segment(cm, lanes, isgood=None):
    """A closure that runs one 2-step segment from step 1 (every row
    proposes) from the chains' start, made here."""
    init_fn, seg_fn = _sampler(cm, isgood)
    keys, spec_b, ctx_b, theta0, use_init = lanes
    carry = init_fn(keys, spec_b, ctx_b, theta0, use_init)
    return lambda: seg_fn(carry, keys, spec_b, ctx_b, 1, 2)


def _solve():
    *model, nlay = model_batch_from_numpy(*eus_batch(load_eus_model(), B=1),
                                          device="cpu")
    return surf_forward_batch(*model, torch.tensor([10.0, 40.0]), nlay)


def _registry():
    return {k: v for k, v in profiling.counters().items()
            if not k.startswith("kernel.")}


def test_tracing_off_enters_no_record_function(priori, monkeypatch):
    cm, lanes = priori

    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not profiling.enabled()
    segment = _segment(cm, lanes)
    before = _registry()
    segment()
    _solve()
    assert _registry() == before
    # counters alone: they count, the spans stay off
    with profiling.counting():
        segment()
        _solve()
    got = _registry()
    assert got["propose.candidates"] > before.get("propose.candidates", 0)
    assert got["host_syncs"] > before.get("host_syncs", 0)


def _spans(path):
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    return [e for e in ev if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("pysurfinv.")], ev


def _inside(child, parents):
    eps = 1e-3
    return any(p["tid"] == child["tid"] and p["ts"] - eps <= child["ts"]
               and child["ts"] + child["dur"] <= p["ts"] + p["dur"] + eps
               for p in parents)


def test_spans_nest_in_the_chrome_trace(priori, tmp_path):
    cm, lanes = priori
    segment = _segment(cm, lanes)
    profiling.reset_counters()
    with profiling.trace(str(tmp_path / "tr")):
        segment()
        n_sampler = dict(profiling.counters())
        _solve()
    counted = profiling.counters()
    spans, events = _spans(tmp_path / "tr" / "trace.json")
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)
    tree = {"pysurfinv.propose": "pysurfinv.segment",
            "pysurfinv.draw": "pysurfinv.propose",
            "pysurfinv.prior": "pysurfinv.propose",
            "pysurfinv.solve.bracket": "pysurfinv.solve",
            "pysurfinv.solve.refine": "pysurfinv.solve",
            "pysurfinv.solve.group": "pysurfinv.solve"}
    for child, parent in tree.items():
        assert by.get(child), f"no {child} span"
        assert all(_inside(c, by[parent]) for c in by[child]), child
    assert len(by["pysurfinv.segment"]) == len(by["pysurfinv.solve"]) == 1
    # one prior span a retry round, as many draws
    assert len(by["pysurfinv.draw"]) == len(by["pysurfinv.prior"])
    assert not _inside(by["pysurfinv.solve"][0], by["pysurfinv.segment"])
    # every host read of a device value in the sampler's window is counted
    # (on the CPU a read is an aten::_local_scalar_dense and nothing else)
    seg = by["pysurfinv.segment"][0]
    reads = [e for e in events
             if e.get("name") == "aten::_local_scalar_dense"
             and _inside(e, [seg])]
    assert n_sampler["host_syncs"] == len(reads) > 0
    assert counted["host_syncs"] == n_sampler["host_syncs"] + 1  # ok.all()
    assert counted["propose.candidates"] > 0


def test_candidates_are_the_rows_the_prior_judged(priori, monkeypatch):
    cm, lanes = priori
    rows, unfound = [], []

    def spy(t, ctx):
        rows.append(t.shape[0])
        return cm.isgood(t, ctx[0])

    def count_unfound(found, _n_unfound=mcmc._n_unfound):
        unfound.append(1)
        return _n_unfound(found)

    monkeypatch.setattr(mcmc, "_n_unfound", count_unfound)
    segment = _segment(cm, lanes, isgood=spy)
    rows.clear()
    unfound.clear()
    profiling.reset_counters()
    with profiling.counting():
        segment()
    got = profiling.counters()
    assert got["propose.candidates"] == sum(rows) > 0
    # one count of unfound lanes a stage's round plus its final check;
    # the prior reads nothing on the host
    assert got["host_syncs"] == len(unfound) > len(rows)
    profiling.reset_counters()
    assert _registry() == {}


def _draw_rounds(cm, lanes, tmp_path):
    """A traced segment's ``pysurfinv.draw`` spans, its counters and the
    round kernel's launches in it."""
    segment = _segment(cm, lanes)
    profiling.reset_counters()
    n0 = DL.draw_round.launches
    with profiling.trace(str(tmp_path / "tr")):
        segment()
        got = profiling.counters()
    spans, _ = _spans(tmp_path / "tr" / "trace.json")
    profiling.reset_counters()
    return (sum(e["name"] == "pysurfinv.draw" for e in spans), got,
            DL.draw_round.launches - n0)


def test_plain_rounds_count_the_draw_spans(priori, tmp_path):
    n_draw, got, launched = _draw_rounds(*priori, tmp_path)
    assert got["draw.plain_rounds"] == n_draw > 0
    assert "draw.kernel_rounds" not in got and launched == 0


@pytest.mark.cuda
def test_kernel_rounds_count_the_draw_spans(priori, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cm, lanes = priori
    keys, spec_b, ctx_b, theta0, use_init = lanes
    dev = lambda x: x.to("cuda")  # noqa: E731
    lanes = (dev(keys), type(spec_b)(*map(dev, spec_b)),
             tuple(map(dev, ctx_b)), dev(theta0), dev(use_init))
    n_draw, got, launched = _draw_rounds(cm, lanes, tmp_path)
    assert got["draw.kernel_rounds"] == n_draw == launched > 0
    assert "draw.plain_rounds" not in got


def _prior_calls(cm, lanes, tmp_path):
    """A traced segment's ``pysurfinv.prior`` spans, its counters and the
    batch shapes its prior saw first there (not at the chains' start)."""
    shapes = set()

    def isgood(t, ctx):
        shapes.add(tuple(t.shape))
        return cm.isgood(t, ctx[0])

    segment = _segment(cm, lanes, isgood)
    seen = set(shapes)
    profiling.reset_counters()
    with profiling.trace(str(tmp_path / "tr")):
        segment()
        got = profiling.counters()
    spans, _ = _spans(tmp_path / "tr" / "trace.json")
    profiling.reset_counters()
    return (sum(e["name"] == "pysurfinv.prior" for e in spans), got,
            shapes - seen)


def test_prior_counts_plain_calls_on_the_cpu(priori, tmp_path):
    n_prior, got, _ = _prior_calls(*priori, tmp_path)
    assert got["prior.plain_calls"] == n_prior > 0
    assert "prior.graph_replays" not in got
    assert "prior.graph_captures" not in got


@pytest.mark.cuda
def test_prior_graph_counters_on_the_card(priori, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    cm, lanes = priori
    keys, spec_b, ctx_b, theta0, use_init = lanes
    dev = lambda x: x.to("cuda")  # noqa: E731
    lanes = (dev(keys), type(spec_b)(*map(dev, spec_b)),
             tuple(map(dev, ctx_b)), dev(theta0), dev(use_init))
    cm = CompiledModel(cm.model)          # no graph yet
    n_prior, got, new_shapes = _prior_calls(cm, lanes, tmp_path)
    assert got["prior.graph_captures"] == len(new_shapes) > 0
    assert got["prior.graph_replays"] == n_prior
    assert "prior.plain_calls" not in got
    # the same shapes again: replays only
    n_prior, got, _ = _prior_calls(cm, lanes, tmp_path)
    assert got["prior.graph_replays"] == n_prior > 0
    assert "prior.graph_captures" not in got
    assert "prior.plain_calls" not in got


def test_tracks_are_the_same_with_tracing_on_and_off(priori, tmp_path):
    cm, lanes = priori
    segment = _segment(cm, lanes)
    carry0, rows0 = segment()
    c0, u0, ok0 = _solve()
    with profiling.trace(str(tmp_path / "tr")):
        carry1, rows1 = segment()
        c1, u1, ok1 = _solve()
    assert torch.equal(rows0, rows1)
    assert all(torch.equal(a, b) for a, b in zip(carry0, carry1))
    assert torch.equal(c0, c1) and torch.equal(u0, u1)
    assert torch.equal(ok0, ok1)


def test_invert_grid_returns_the_call_counters(tmp_path, monkeypatch):
    monkeypatch.setenv("PYSURFINV_MCMC_NEWTON_SEP", "0")
    monkeypatch.setenv("PYSURFINV_MCMC_NBISECT", "2")
    pts = [PointCascadia(SETTING, dict(LOCAL, sedthk=s), periods=PERIODS[SUB],
                         vels=VELS[SUB], uncers=UNCERS[SUB]) for s in SEDS]
    stats = {}
    invert_grid(pts, [(229.0, 46.0), (229.5, 46.0)],
                outdir=str(tmp_path / "mc"), runN=8, chainL=4, seed=3,
                segment=2, verbose=False, device="cpu", stats=stats)
    c = stats["counters"]
    # two segments: their rows and 5-part carries to the host, at least
    # one ok.all() a posterior step
    assert c["host_syncs"] >= 2 * 6 + 4
    assert c["propose.candidates"] > 0 and c["compress.busy_s"] > 0
    assert {f"kernel.{k}" for k in ("secular_lanes", "secular_lanes_frozen",
                                    "secular_lanes_grad", "refine_lanes")} \
        <= set(c)
    assert not profiling.enabled()


def test_counters_lose_no_update_across_threads():
    """Worker threads (the compressor's) count beside the main thread:
    more threads than cores, a short switch interval, no lost update."""
    import os
    import sys
    import threading

    n, m = 2 * (os.cpu_count() or 1) + 2, 2000

    def work():
        for _ in range(m):
            profiling.count("stress", 1)

    old = sys.getswitchinterval()
    profiling.reset_counters()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(n)]
        with profiling.counting():
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()["stress"] == n * m
    profiling.reset_counters()

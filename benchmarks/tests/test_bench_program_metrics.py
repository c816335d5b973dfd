"""The readers of the program's own spans and counters on the CPU: a
hand-written Chrome trace whose idle gaps and ``pysurfinv.*`` spans
give a known answer, and counters counted by hand."""

from __future__ import annotations

import pytest

import run as R
from harness import program_spans as PS
from harness.cells import Cell
from harness.tracing import WINDOW_SPAN, Trace

from pysurfinv_tpu_torch import profiling


def _ev(name, ts, dur, tid=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def _trace():
    """Window [0, 1000] µs; device busy [100, 300] and [500, 600], so idle
    [0, 100], [300, 500] and [600, 1000]."""
    return Trace([
        _ev(WINDOW_SPAN, 0.0, 1000.0),
        _ev("bench.segment", 0.0, 1000.0),
        _ev("pysurfinv.segment", 10.0, 980.0),
        # half of the idle gap [300, 500] falls inside this draw
        _ev("pysurfinv.draw", 200.0, 200.0),
        _ev("pysurfinv.draw", 250.0, 100.0),        # nested: counted once
        _ev("pysurfinv.prior", 600.0, 100.0),
        _ev("aten::add", 620.0, 10.0, cat="cpu_op"),
        # another thread's span is not the window's
        _ev("pysurfinv.draw", 0.0, 1000.0, tid=2),
        _ev("pysurfinv.solve", 50.0, 900.0),
        _ev("k", 100.0, 200.0, tid=7, cat="kernel"),
        _ev("k", 500.0, 100.0, tid=7, cat="kernel"),
    ])


def _ctx(cell, trace, units, lanes=4):
    class E:
        unit_name, n = "unit", lanes

    ctx = R.Context(E(), units, 1.0, {}, trace)
    return lambda m: Cell(cell).reader(m)(ctx)


SURVEY = [(0.0, 0.5, 40), (0.5, 1.0, 40)]      # 80 samples, 20 steps
CALLS = [(0.0, 0.5, 8), (0.5, 1.0, 8)]


@pytest.fixture
def counted():
    profiling.reset_counters()
    with profiling.counting():
        profiling.count("propose.candidates", 120)
        profiling.count("host_syncs", 30)
    yield
    profiling.reset_counters()


def test_idle_inside_spans():
    tr = _trace()
    assert PS.span_intervals(tr, "pysurfinv.draw") == [(200.0, 400.0)]
    assert PS.idle_in_spans_s(tr, "pysurfinv.draw") == pytest.approx(100e-6)
    assert PS.idle_in_spans_s(tr, "pysurfinv.prior") == pytest.approx(100e-6)
    # 50 + 200 + 350 µs of the gaps
    assert PS.idle_in_spans_s(tr, "pysurfinv.solve") == pytest.approx(600e-6)
    assert PS.idle_in_spans_s(tr, "pysurfinv.compact") is None
    assert PS.idle_in_spans_s(None, "pysurfinv.draw") is None


def test_survey_readers(counted):
    read = _ctx("survey.ocean.priori", _trace(), SURVEY)
    assert read("draw_idle_ms_per_step.survey") == pytest.approx(0.1 / 20)
    assert read("prior_idle_ms_per_step.survey") == pytest.approx(0.1 / 20)
    assert read("prior_evals_per_sample.survey") == pytest.approx(120 / 80)
    assert read("host_syncs_per_step.survey") == pytest.approx(30 / 20)


def test_forward_readers(counted):
    read = _ctx("forward.ocean.batch", _trace(), CALLS)
    assert read("solve_idle_ms_per_call.forward") == pytest.approx(0.3)
    assert read("host_syncs_per_call.forward") == pytest.approx(15.0)


@pytest.mark.parametrize("metric,cell", [
    ("prior_evals_per_sample.survey", "survey.ocean.priori"),
    ("host_syncs_per_step.survey", "survey.ocean.priori"),
    ("draw_idle_ms_per_step.survey", "survey.ocean.priori"),
    ("prior_idle_ms_per_step.survey", "survey.ocean.priori"),
    ("host_syncs_per_call.forward", "forward.ocean.batch"),
    ("solve_idle_ms_per_call.forward", "forward.ocean.batch"),
])
def test_nothing_to_read_gives_none(metric, cell, counted, monkeypatch):
    # an untraced run
    assert _ctx(cell, None, SURVEY)(metric) is None
    # a program without counters or spans (as before it had them)
    monkeypatch.delattr(profiling, "counters")
    bare = Trace([_ev(WINDOW_SPAN, 0.0, 1000.0),
                  _ev("k", 100.0, 200.0, tid=7, cat="kernel")])
    assert _ctx(cell, bare, SURVEY)(metric) is None

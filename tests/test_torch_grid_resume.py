"""Checkpoint/resume, lane ranges and the streamed npz writer of the
port's ``invert_grid``, on the CPU.

Every draw of the batched sampler is a pure function of (lane key,
global row) and each lane carries its own warm roots, so an interrupted
and resumed run, a tiled run, and a run whose lanes are split into
ranges over several processes (including ranges of a single lane) all
write the tracks of the uninterrupted one-range run, bit for bit.  The
streamed files (rows deflated lane by lane as each segment lands) load
equal, array by array, to the ``savez_fast`` files of
``PYSURFINV_STREAM_NPZ=0``, and the JAX package's ``PostPoint`` reads a
streamed file as it reads the ``savez_fast`` one (1e-12).  The cuts of
tests/test_torch_sampler.py keep the CPU solve cheap: 3 periods,
``PYSURFINV_MCMC_NEWTON_SEP=0``, a 2-iteration Illinois; 2 points x 2
chains x 6 steps in segments of 2.
"""

import os

import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu_torch.inversion.point import PointCascadia
from pysurfinv_tpu_torch.parallel.grid import invert_grid

torch.set_num_threads(1)

SUB = slice(0, 18, 8)  # 10, 26 and 70 s: both bands of the misfit
LLS = [(229.0, 46.0), (229.5, 46.0)]
KW = dict(runN=12, chainL=6, seed=5, segment=2, verbose=False)
ENV = {"PYSURFINV_MCMC_NEWTON_SEP": "0", "PYSURFINV_MCMC_NBISECT": "2"}


@pytest.fixture(autouse=True)
def _cheap_solver(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)


def _points():
    return [PointCascadia(SETTING, dict(LOCAL, sedthk=sed),
                          periods=PERIODS[SUB], vels=VELS[SUB],
                          uncers=UNCERS[SUB]) for sed in (0.019, 0.5)]


def _tracks(paths):
    return [np.load(p, allow_pickle=True)["mcTrack"] for p in paths]


def _run(out, **kw):
    args = dict(KW, device="cpu")
    args.update(kw)
    return invert_grid(_points(), LLS, outdir=str(out), **args)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted one-range run: (paths, tracks)."""
    mp = pytest.MonkeyPatch()
    for k, v in ENV.items():
        mp.setenv(k, v)
    try:
        paths = _run(tmp_path_factory.mktemp("ref") / "mc")
    finally:
        mp.undo()
    tr = _tracks(paths)
    assert all(t.shape == (12, 9) and np.isfinite(t).all() for t in tr)
    assert all((t[:, 0] < 88888).all() for t in tr)
    assert 0 < sum(t[:, 2].sum() for t in tr) < 24  # accepts and rejects
    return paths, tr


def _equal(paths, reference):
    for got, ref in zip(_tracks(paths), reference[1]):
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_seg", [1, 2])
def test_resume_equals_uninterrupted(reference, tmp_path, n_seg):
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path / "mc", checkpoint=ck, _abort_after_segments=n_seg)
    saved = np.load(ck)
    assert int(saved["s"]) == 2 * n_seg
    assert saved["rows"].shape == (2 * n_seg, 4, 9)
    # the carry keeps its dtypes: float64 theta/misfit/chi/L, float32 roots
    assert [saved[f"carry{i}"].dtype for i in range(5)] == \
        [np.float64] * 4 + [np.float32]
    _equal(_run(tmp_path / "mc", checkpoint=ck, resume=True), reference)


def test_resume_of_tiled_grid(reference, tmp_path):
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path / "mc", checkpoint=ck, max_lanes=2,
             _abort_after_segments=1)
    assert os.path.exists(ck + ".tile0") and not os.path.exists(ck)
    _equal(_run(tmp_path / "mc", checkpoint=ck, resume=True, max_lanes=2),
           reference)
    assert os.path.exists(ck + ".tile1")


def test_resume_with_other_configuration_raises(tmp_path):
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path / "mc", checkpoint=ck, _abort_after_segments=1)
    with pytest.raises(ValueError, match="different run configuration"):
        _run(tmp_path / "mc", checkpoint=ck, resume=True, seed=6)


@pytest.mark.parametrize("devices", [["cpu", "cpu"], ["cpu"] * 3],
                         ids=["two", "three_uneven"])
def test_lane_ranges_equal_one_range(reference, tmp_path, devices):
    """4 lanes over 2 processes (2 + 2) and over 3 (2 + 1 + 1: two
    ranges of a single lane)."""
    stats = {}
    _equal(_run(tmp_path / "mc", device=devices, stats=stats), reference)
    ranges = [r["lanes"] for r in stats["ranges"]]
    assert ranges == ([(0, 2), (2, 4)] if len(devices) == 2
                      else [(0, 2), (2, 3), (3, 4)])


def test_lane_ranges_resume(reference, tmp_path):
    """Each range writes its own checkpoint, ``<ck>.range{j}``."""
    ck = str(tmp_path / "ck.npz")
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path / "mc", checkpoint=ck, device=["cpu", "cpu"],
             _abort_after_segments=1)
    assert all(os.path.exists(f"{ck}.range{j}") for j in (0, 1))
    _equal(_run(tmp_path / "mc", checkpoint=ck, resume=True,
                device=["cpu", "cpu"]), reference)


def test_streamed_npz_equals_savez_fast(reference, tmp_path, monkeypatch):
    monkeypatch.setenv("PYSURFINV_STREAM_NPZ", "0")
    plain = _run(tmp_path / "mc")
    for fs, fp in zip(reference[0], plain):
        a, b = np.load(fs, allow_pickle=True), np.load(fp, allow_pickle=True)
        assert sorted(a.files) == sorted(b.files) == [
            "invMeta", "mcTrack", "obs", "setting"]
        np.testing.assert_array_equal(a["mcTrack"], b["mcTrack"])
        assert a["mcTrack"].dtype == b["mcTrack"].dtype
        for k in ("invMeta", "obs", "setting"):
            assert repr(a[k][()]) == repr(b[k][()])


def test_jax_post_point_reads_streamed_file(reference, tmp_path,
                                            monkeypatch):
    from pysurfinv_tpu.inversion.point import PostPointCascadia

    monkeypatch.setenv("PYSURFINV_STREAM_NPZ", "0")
    plain = _run(tmp_path / "mc")[0]
    ps, pp = PostPointCascadia(reference[0][0]), PostPointCascadia(plain)
    np.testing.assert_allclose(ps.MCparas, pp.MCparas, rtol=1e-12)
    np.testing.assert_array_equal(ps.accFinal, pp.accFinal)
    assert ps.thres == pytest.approx(pp.thres, rel=1e-12)
    for name in ("minMod", "avgMod"):
        a, b = getattr(ps, name), getattr(pp, name)
        np.testing.assert_allclose(a._brownians(), b._brownians(),
                                   rtol=1e-12)
        assert a.misfit == pytest.approx(b.misfit, rel=1e-12)


def test_transient_fault_rolls_back_to_last_segment(reference, tmp_path,
                                                    monkeypatch):
    """A transient fault in a segment (the card busy) rolls the run back
    to the last committed segment's host copy of the carry and re-runs
    from there: the tracks are the uninterrupted run's."""
    from pysurfinv_tpu_torch.parallel import grid

    real = grid.batched_sampler
    calls = []

    def flaky(*a, **kw):
        init_fn, seg_fn = real(*a, **kw)

        def seg(carry, *args):
            calls.append(args[-2])
            if len(calls) == 2:  # the second segment fails once
                raise RuntimeError("CUDA error: all CUDA-capable devices "
                                   "are busy or unavailable")
            return seg_fn(carry, *args)

        return init_fn, seg

    monkeypatch.setattr(grid, "batched_sampler", flaky)
    monkeypatch.setattr(grid, "RETRY_BACKOFF_S", 0.0)
    _equal(_run(tmp_path / "mc"), reference)
    assert calls == [0, 2, 2, 4]  # step 2 re-run from its committed start

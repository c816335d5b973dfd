"""Port parity of the posterior comparator (``inversion/parity.py``).

One set of seeded npz chain files — thetas of a prior run of the
Cascadia fixture with seeded misfits and accept flags — goes through
both packages: the chain statistics (acceptance, convergence, theta
means/stds, Vs(z) quantiles through each package's compiled model) to
1e-12 relative, the pooled threshold exactly, and ``compare_posteriors``
with the same seed to identical p-values, by exact enumeration and by
random permutations.  ``fast_host_prior`` gives the JAX package's
verdicts on seeded models.  ``scripts/posterior_parity_torch.py``
compares two npz directories and prints one JSON verdict line.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu.inversion import parity as jparity
from pysurfinv_tpu.models.model1d import buildModel1D as jbuild
from pysurfinv_tpu_torch.inversion import parity as tparity
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.point import PointCascadia
from pysurfinv_tpu_torch.models.model1d import buildModel1D as tbuild

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZDEPS = [5.0, 30.0, 100.0]
CHAIN_L = 20
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Two directories of npz files, (side A: 2 files x 3 chains, side
    B: 2 files x 3 chains), thetas from a seeded prior run."""
    base = tmp_path_factory.mktemp("parity")
    p = PointCascadia(SETTING, dict(LOCAL), periods=PERIODS, vels=VELS,
                      uncers=UNCERS)
    p.MCinvMP(str(base / "pri"), pid="p", runN=12 * CHAIN_L,
              chainL=CHAIN_L, seed=2, priori=True, verbose=False, **CPU)
    th = np.load(base / "pri_priori" / "p.npz",
                 allow_pickle=True)["mcTrack"][:, 3:]
    rng = np.random.default_rng(0)
    dirs = []
    for side, shift in (("a", 0.0), ("b", 0.1)):
        d = base / side
        d.mkdir()
        for f in range(2):
            n = 3 * CHAIN_L
            lo = (2 * (side == "b") + f) * n
            mis = 1.0 + shift + rng.exponential(0.4, n)
            acc = (rng.random(n) < 0.4).astype(float)
            acc[::CHAIN_L] = 1.0  # a chain's first row is accepted
            track = np.column_stack([mis, np.exp(-mis), acc,
                                     th[lo:lo + n]])
            np.savez(d / f"{f}.npz", mcTrack=track,
                     invMeta={"pid": f"{f}", "chainL": CHAIN_L})
        dirs.append(str(d))
    return dirs


def _assert_stats(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape and a.shape[0] == 6
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=k)


def test_chain_statistics_match_jax(groups):
    fa, fb = (tparity.glob_npz(d) for d in groups)
    assert fa == jparity.glob_npz(groups[0]) and len(fa) == 2
    thres = tparity.pooled_threshold([fa, fb])
    assert thres == jparity.pooled_threshold([fa, fb])
    mt = tbuild(SETTING, dict(LOCAL))
    mj = jbuild(SETTING, dict(LOCAL))
    for files in (fa, fb):
        st, tt = tparity.chain_statistics(files, zdeps=ZDEPS, thres=thres,
                                          vs_model=mt, **CPU)
        sj, tj = jparity.chain_statistics(files, zdeps=ZDEPS, thres=thres,
                                          vs_model=mj)
        assert tt == tj
        _assert_stats(st, sj)
        assert np.isfinite(st["vs_z30_q0.5"]).all()
    # the file's own threshold, no Vs quantiles
    st, tt = tparity.chain_statistics(fa)
    sj, tj = jparity.chain_statistics(fa)
    assert tt == tj
    _assert_stats(st, sj)


@pytest.mark.parametrize("n_perm", [None, 300], ids=["exact", "sampled"])
def test_compare_posteriors_matches_jax(groups, n_perm):
    fa, fb = (tparity.glob_npz(d) for d in groups)
    thres = tparity.pooled_threshold([fa, fb])
    sa, _ = tparity.chain_statistics(fa, thres=thres)
    sb, _ = tparity.chain_statistics(fb, thres=thres)
    if n_perm:  # more chains a side than exact enumeration takes
        sa = {k: np.concatenate([v, v[::-1], v]) for k, v in sa.items()}
        sb = {k: np.concatenate([v, v, v[::-1]]) for k, v in sb.items()}
    kw = dict(n_perm=n_perm, seed=3) if n_perm else {}
    got = tparity.compare_posteriors(sa, sb, **kw)
    ref = jparity.compare_posteriors(sa, sb, **kw)
    assert got["exact"] is ref["exact"] is (n_perm is None)
    for k in ("p_max", "p_rms", "p_mean", "p_value", "n_a", "n_b",
              "worst"):
        assert got[k] == ref[k], k
    for k in ("max_abs_z", "rms_z", "mean_abs_z"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12)
    assert got["z"] == pytest.approx(ref["z"], rel=1e-12)


def test_fast_host_prior_matches_jax():
    mt = tbuild(SETTING, dict(LOCAL))
    mj = jbuild(SETTING, dict(LOCAL))
    gt = tparity.fast_host_prior(mt, **CPU)
    gj = jparity.fast_host_prior(mj)
    rng = np.random.default_rng(5)
    spec = CompiledModel(mt).spec
    th0, lo, hi = spec.theta0, spec.vmin, spec.vmax
    verdicts = []
    for i in range(12):
        th = (lo + rng.random(len(lo)) * (hi - lo) if i % 2
              else np.clip(th0 + 0.02 * rng.standard_normal(len(lo)),
                           lo, hi))
        a, b = mt.copy(), mj.copy()
        a._loadMC(th)
        b._loadMC(th)
        verdicts.append(gt(a))
        assert verdicts[-1] == gj(b)
    assert 0 < sum(verdicts) < len(verdicts)  # both outcomes exercised


def test_parity_script_on_two_dirs(groups):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts",
                                      "posterior_parity_torch.py"),
         "--host-dir", groups[0], "--device-dir", groups[1],
         "--device", "cpu", "--n-perm", "200"],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert 0 <= res["p_value"] <= 1
    assert res["n_host_chains"] == res["n_device_chains"] == 6
    assert np.isfinite(res["max_abs_z"])

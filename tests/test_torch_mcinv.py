"""Port parity of the batched sampler end to end: ``invert_grid`` in
prior mode follows the JAX package's tracks draw for draw, and
``Point.MCinvMP`` with the likelihood writes the JAX package's reference
npz, its chains starting where the JAX package's do.
"""

import numpy as np

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu.inversion.point import PointCascadia as JaxPoint
from pysurfinv_tpu.parallel.grid import invert_grid as jax_invert_grid
from pysurfinv_tpu_torch.inversion.point import PointCascadia
from pysurfinv_tpu_torch.parallel.grid import invert_grid

LLS = [(229.0, 46.0), (229.5, 46.0)]


def _points(cls):
    pts = []
    for sed in (0.019, 0.5):
        loc = dict(LOCAL)
        loc["sedthk"] = sed
        pts.append(cls(SETTING, loc, periods=PERIODS, vels=VELS,
                       uncers=UNCERS))
    return pts


def _track(outdir, lonlat):
    lon, lat = lonlat
    return np.load(f"{outdir}/{lon:g}_{lat:g}.npz",
                   allow_pickle=True)["mcTrack"]


# ---------------------------------------------------------------------------
# (e) the sampler, draw for draw
# ---------------------------------------------------------------------------

def test_priori_tracks_match_jax(tmp_path):
    """Prior sampling runs the proposal pyramid, the prior and the RNG
    streams without a solve: thetas to 1e-10 relative, accept and L
    columns equal."""
    kw = dict(runN=32, chainL=8, seed=3, priori=True, verbose=False)
    jax_invert_grid(_points(JaxPoint), LLS, outdir=str(tmp_path / "j"),
                    **kw)
    invert_grid(_points(PointCascadia), LLS, outdir=str(tmp_path / "t"),
                device="cpu", **kw)
    for ll in LLS:
        a = _track(tmp_path / "j_priori", ll)
        b = _track(tmp_path / "t_priori", ll)
        assert a.shape == b.shape == (32, 3 + 6)
        np.testing.assert_array_equal(b[:, :3], a[:, :3])
        np.testing.assert_allclose(b[:, 3:], a[:, 3:], rtol=1e-10)
        assert len(np.unique(b[:, 3])) > 8  # the chains move




def test_mcinvmp_writes_reference_chains(tmp_path, monkeypatch):
    """(h) MCinvMP runN 48 / chainL 16 with the likelihood: the npz keys,
    shapes and metadata of the JAX package's, and each chain's init row
    (chain 0 from the initial model, the others from prior-accepted
    uniform draws) with the same thetas to 1e-10 relative and accepted.
    The init rows' misfits agree to 1e-2 relative: the port solves in
    float32, the JAX package on the CPU in float64, and the misfit
    (uncertainties 5e-3 km/s) moves ~1e-2 per 5e-5 km/s of root.
    Illinois refinement keeps the CPU solve cheap (the JAX package's CPU
    path refines with Illinois too)."""
    monkeypatch.setenv("PYSURFINV_MCMC_NEWTON_SEP", "0")
    kw = dict(pid="p", runN=48, chainL=16, seed=1, verbose=False)
    JaxPoint(SETTING, LOCAL, periods=PERIODS, vels=VELS,
             uncers=UNCERS).MCinvMP(outdir=str(tmp_path / "j"), **kw)
    PointCascadia(SETTING, LOCAL, periods=PERIODS, vels=VELS,
                  uncers=UNCERS).MCinvMP(outdir=str(tmp_path / "t"),
                                         device="cpu", **kw)
    a = np.load(tmp_path / "j" / "p.npz", allow_pickle=True)
    b = np.load(tmp_path / "t" / "p.npz", allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    assert b["mcTrack"].shape == a["mcTrack"].shape == (48, 9)
    for key in ("obs", "invMeta"):
        assert repr(b[key][()]) == repr(a[key][()])
    assert b["setting"][()].keys() == a["setting"][()].keys()
    ta, tb = a["mcTrack"], b["mcTrack"]
    assert np.isfinite(tb).all() and set(np.unique(tb[:, 2])) <= {0.0, 1.0}
    init = slice(0, 48, 16)
    np.testing.assert_allclose(tb[init, 3:], ta[init, 3:], rtol=1e-10)
    assert (tb[init, 2] == 1).all() and (ta[init, 2] == 1).all()
    np.testing.assert_allclose(tb[init, 0], ta[init, 0], rtol=1e-2)
    assert (tb[:, 0] < 88888).all()

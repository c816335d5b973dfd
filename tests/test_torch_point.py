"""Port parity of the host inversion surface, float64 on the CPU.

The forward calls — ``calForward``, ``Model1D.forward``, ``fast_surf``,
``CompiledModel.forward`` — and the misfits ``Point.misfit`` /
``PointCascadia.misfit`` against the JAX package's on the same model to
1e-8; the host-sequential oracle ``Point.MCinv`` with the same seed
(runN 6, chainL 3, 5 periods) writes the JAX package's track to 1e-8
with identical accept flags; ``PostPoint`` on that npz gives the JAX
package's minMod / avgMod parameters, threshold, accepted set and
batched Vs(z) values.  The sediment starts at 0.5 km, so no perturbed
model drops a thin layer and the JAX solve compiles for one shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu import compat as jcompat
from pysurfinv_tpu.inversion import point as jpoint
from pysurfinv_tpu.inversion.compiled import CompiledModel as JaxCompiled
from pysurfinv_tpu.models import model1d as jm
from pysurfinv_tpu_torch import compat as tcompat
from pysurfinv_tpu_torch.inversion import point as tpoint
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.models import model1d as tm

torch.set_num_threads(1)

T5, V5, U5 = PERIODS[::4], VELS[::4], UNCERS[::4]
LOC = dict(LOCAL, sedthk=0.5)
CPU = dict(device="cpu")


def _points(mod, cls="PointCascadia"):
    return getattr(mod, cls)(SETTING, dict(LOC), periods=T5, vels=V5,
                             uncers=U5)


@pytest.fixture(scope="module")
def profile():
    mod = tm.buildModel1D(SETTING, dict(LOC))
    return np.array(mod.seisPropLayers(refLayer=True)[:-1])


def test_cal_forward_and_model_forward(profile):
    ref = jm.calForward(profile, periods=T5)
    got = tm.calForward(profile, periods=T5, **CPU)
    assert got.dtype == np.float64 and got.shape == (5,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    mj, mt = jm.buildModel1D(SETTING, dict(LOC)), tm.buildModel1D(
        SETTING, dict(LOC))
    np.testing.assert_allclose(mt.forward(T5, **CPU), mj.forward(T5),
                               rtol=0, atol=1e-8)
    # the failed-forward convention: any c < 0.01 -> None
    bad = profile.copy()
    bad[2] = 0.0
    assert tm.calForward(bad, periods=T5, **CPU) is None
    with pytest.raises(ValueError):
        tm.calForward(profile, wavetype="SH", **CPU)


@pytest.mark.parametrize("kind", [2, 1], ids=["rayleigh", "love"])
def test_fast_surf(profile, kind):
    h, vs, vp, rho, qs = profile[:5]
    n = len(h)
    per = np.zeros(200)
    per[:5] = T5
    args = (n, kind, vp, vs, rho, h, 1.0 / qs, per, 5)
    ref = jcompat.fast_surf(*args)
    got = tcompat.fast_surf(*args, **CPU)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and a.shape == (200,)
        # float64 solves that agree to 1e-8, each rounded to float32:
        # at most one float32 spacing apart
        assert (np.abs(a - b) <= np.spacing(np.abs(b))).all()
    idx = 2 if kind == 2 else 3
    assert (got[idx][:5] > 3).all() and not got[idx][5:].any()


def test_compiled_forward():
    mj = jm.buildModel1D(SETTING, dict(LOC))
    cj, ct = JaxCompiled(mj), CompiledModel(tm.buildModel1D(SETTING,
                                                            dict(LOC)))
    per = np.asarray(T5, float)
    ref = np.asarray(jax.jit(lambda th: cj.forward(th, jnp.asarray(per)))(
        jnp.asarray(cj.spec.theta0)))
    theta = torch.tensor(ct.spec.theta0)
    got = ct.forward(theta, torch.tensor(per))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8)
    h, vp, vs, rho, qsi, nlay = ct.build_profile(theta)
    assert h.shape == (ct.L,) and nlay == ct._n_nodes - 1


@pytest.mark.parametrize("cls", ["Point", "PointCascadia"])
def test_misfit(cls):
    ref = _points(jpoint, cls).misfit()
    got = _points(tpoint, cls).misfit(**CPU)
    np.testing.assert_allclose(got, ref, rtol=1e-8)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    """The same seeded MCinv through both packages: (JAX npz, port npz)."""
    out = tmp_path_factory.mktemp("mcinv")
    kw = dict(pid="p", runN=6, chainL=3, seed=5)
    _points(jpoint).MCinv(outdir=str(out / "j"), **kw)
    _points(tpoint).MCinv(outdir=str(out / "t"), **kw, **CPU)
    return str(out / "j" / "p.npz"), str(out / "t" / "p.npz")


def test_mcinv_tracks_match_jax(chains):
    a = np.load(chains[0], allow_pickle=True)
    b = np.load(chains[1], allow_pickle=True)
    assert sorted(a.files) == sorted(b.files)
    ta, tb = a["mcTrack"], b["mcTrack"]
    assert tb.shape == ta.shape == (6, 9)
    np.testing.assert_array_equal(tb[:, 2], ta[:, 2])
    np.testing.assert_allclose(tb, ta, rtol=1e-8, atol=1e-8 * 1e-8)
    assert (tb[:, 0] < 88888).all() and np.isfinite(tb).all()
    for key in ("obs", "invMeta"):
        assert repr(b[key][()]) == repr(a[key][()])


def test_post_point_matches_jax(chains):
    pj = jpoint.PostPointCascadia(chains[0])
    pt = tpoint.PostPointCascadia(chains[1], **CPU)
    np.testing.assert_allclose(pt.MCparas, pj.MCparas, rtol=1e-8)
    assert pt.thres == pytest.approx(pj.thres, rel=1e-8)
    np.testing.assert_array_equal(pt.accFinal, pj.accFinal)
    for name in ("minMod", "avgMod"):
        a, b = getattr(pt, name), getattr(pj, name)
        np.testing.assert_allclose(a._brownians(), b._brownians(),
                                   rtol=1e-8)
        assert a.misfit == pytest.approx(b.misfit, rel=1e-8)
        assert a.L == pytest.approx(b.L, rel=1e-8, abs=1e-300)
    z = np.linspace(0.0, 150.0, 31)
    vt, vj = pt._loadValues(zdeps=z), pj._loadValues(zdeps=z)
    assert vt.shape == vj.shape == (31, int(pj.accFinal.sum()))
    np.testing.assert_allclose(vt, vj, rtol=1e-8)
    np.testing.assert_allclose(pt._loadValues(), pj._loadValues(),
                               rtol=1e-12)


def test_post_point_plots(chains):
    """The posterior plot surface on the port's npz (the calls of
    tests/test_compiled_mcmc.py:128-137, 232-252), with the chain as its
    own prior; the dispersion plot's curves are the JAX package's."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    post = tpoint.PostPointCascadia(chains[1], chains[1], **CPU)
    pj = jpoint.PostPointCascadia(chains[0])
    plt.close("all")
    assert len(post.plotVsProfile(allAccepted=True).lines) >= 3
    assert len(post.plotVsProfileGrid(allAccepted=True).lines) >= 3
    _, ax = post.plotDisp(ensemble=False)
    for line, mod in zip(ax.lines[-3:], (pj.initMod, pj.avgMod, pj.minMod)):
        np.testing.assert_allclose(line.get_ydata(), mod.forward(T5),
                                   rtol=0, atol=1e-8)
    assert len(post.plotVsProfileShaded().collections) >= 1
    n = len(plt.get_fignums())
    post._check_distribution(zdeps=[20.0, 60.0])
    post._check_history()
    # 20 sub-lengths of chainL: the 3-step chains here would give empty
    # ones
    post.invMeta = dict(post.invMeta, chainL=20)
    post._check_convergency(zdeps=[20.0])
    assert len(plt.get_fignums()) == n + 2 + 1 + 2
    plt.close("all")

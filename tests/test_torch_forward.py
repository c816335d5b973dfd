"""Port parity of the single-model solve ``surf_forward`` (with overtones)
and of ``surf_ellipticity`` / ``surf_amplitude``, float64 on the CPU.

Against the JAX package's ``surf_forward`` on the same numpy inputs:
equal ``valid`` masks, |dc| <= 1e-8 km/s and |du| <= 1e-7 km/s (the eus
model, Rayleigh and Love, ``nmodes=2``, 5 periods; and the sparse period
list T = [10, 30, 60], which runs the rescue pass).  Against the TEST1
golden curves with the tolerances of tests/test_dispersion_golden.py.
Ellipticity and amplitude against the JAX package to 1e-8 relative on a
water-covered layered model, and the textbook Poisson halfspace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_dispersion_golden import GRV_MEDIAN_TOL, _phase_tol

from pysurfinv_tpu.ops import dispersion as jd
from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, surf_amplitude,
                                                surf_ellipticity,
                                                surf_forward)

torch.set_num_threads(1)

KEYS = ("h", "vp", "vs", "rho", "qsinv")


def _port(m, periods, wave, **kw):
    c, u, ok = surf_forward(*(torch.tensor(np.asarray(m[k], np.float64))
                              for k in KEYS),
                            torch.tensor(np.asarray(periods, np.float64)),
                            m["nlay"], wave=wave, cfg=SurfConfig(**kw))
    assert c.dtype == torch.float64
    return c.numpy(), u.numpy(), ok.numpy()


def _jax(m, periods, wave, **kw):
    out = jd.surf_forward(*(jnp.asarray(m[k]) for k in KEYS),
                          jnp.asarray(np.asarray(periods, np.float64)),
                          m["nlay"], wave=wave, cfg=jd.SurfConfig(**kw))
    return tuple(np.asarray(x) for x in out)


def _assert_same(port, ref):
    (ct, ut, okt), (cj, uj, okj) = port, ref
    assert ct.shape == cj.shape
    np.testing.assert_array_equal(okt, okj)
    assert okj.all()
    assert np.abs(ct - cj).max() <= 1e-8
    assert np.abs(ut - uj).max() <= 1e-7


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_surf_forward_overtones_match_jax_f64(eus_model, wave):
    """nmodes=2 over 5 periods: the overtone chain, its 0.1 dc margin
    above the 12-iteration estimate and the phase-3 forward-mode group
    velocity against jax.jvp's."""
    per = eus_model["periods"][:5]
    port = _port(eus_model, per, wave, nmodes=2)
    _assert_same(port, _jax(eus_model, per, wave, nmodes=2))
    assert (port[0][:, 1] > port[0][:, 0]).all()


def test_sparse_period_list_rescue_matches_jax(eus_model):
    """T = [10, 30, 60] outruns the warm window: the cold rescue pass
    re-brackets the failed periods, as in the JAX package."""
    sparse = [10.0, 30.0, 60.0]
    _assert_same(_port(eus_model, sparse, "rayleigh"),
                 _jax(eus_model, sparse, "rayleigh"))


@pytest.fixture(scope="module")
def golden_port(eus_model):
    return {w: _port(eus_model, eus_model["periods"], w, nmodes=2)
            for w in ("rayleigh", "love")}


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
@pytest.mark.parametrize("mode", [0, 1])
def test_golden_test1(golden_port, golden, wave, mode):
    """The TEST1 curves, modes 0 and 1, with the per-period phase and
    group tolerances of tests/test_dispersion_golden.py."""
    c, u, ok = golden_port[wave]
    wt = "R" if wave == "rayleigh" else "L"
    refc = golden[f"phv_{wt}_{mode}"][:, 1]
    refu = golden[f"grv_{wt}_{mode}"][:, 1]
    tol = _phase_tol(golden, wt, mode)
    assert ok[:, mode].all()
    rel_c = np.abs(c[:, mode] - refc) / refc
    rel_u = np.abs(u[:, mode] - refu) / refu
    assert (rel_c < tol).all() and np.median(rel_c) < 1e-6
    assert (rel_u < 10 * tol).all()
    assert np.median(rel_u) < GRV_MEDIAN_TOL[mode]
    if mode == 0:  # test_fundamental_tight
        assert np.abs(c[:, 0] - refc).max() / refc.max() < 1e-5
        assert np.abs(u[:, 0] - refu).max() / refu.max() < 5e-5


def _water_model(L=8):
    """2.5 km of water over sediment, a two-layer crust and a mantle
    halfspace, padded to L."""
    h = [2.5, 0.8, 3.0, 4.0, 0.0]
    vs = [0.0, 0.7, 3.2, 3.7, 4.4]
    vp = [1.475, 1.9, 5.8, 6.6, 7.9]
    rho = [1.027, 1.9, 2.7, 2.9, 3.3]
    qsi = [1e-4, 1 / 80, 1 / 300, 1 / 400, 1 / 150]
    n = len(h)
    pad = lambda x, f: np.array(x + [f] * (L - n), np.float64)  # noqa
    return {"h": pad(h, 0.0), "vs": pad(vs, vs[-1]), "vp": pad(vp, vp[-1]),
            "rho": pad(rho, rho[-1]), "qsinv": pad(qsi, qsi[-1]), "nlay": n}


@pytest.mark.parametrize("name", ["surf_ellipticity", "surf_amplitude"])
def test_ellipticity_amplitude_match_jax(name):
    """The e2/e3-seeded pair recursion (liquid layers skipped, one shared
    scale) and the liquid-top modulation, at each root: 1e-8 relative."""
    m = _water_model()
    per = np.array([4.0, 8.0, 15.0, 30.0])
    port_fn = {"surf_ellipticity": surf_ellipticity,
               "surf_amplitude": surf_amplitude}[name]
    vt, ct, okt = port_fn(*(torch.tensor(m[k]) for k in KEYS),
                          torch.tensor(per), m["nlay"], cfg=SurfConfig())
    vj, cj, okj = getattr(jd, name)(*(jnp.asarray(m[k]) for k in KEYS),
                                    jnp.asarray(per), m["nlay"],
                                    cfg=jd.SurfConfig())
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert np.asarray(okj).all()
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-8)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8)
    assert np.isfinite(vt.numpy()).all() and (np.abs(vt.numpy()) > 0).all()


def test_halfspace_ellipticity_poisson():
    """Uniform Poisson halfspace (tests/test_eigen.py:303-323): c = 0.9194
    beta, H/V independent of period and equal to the textbook 0.681."""
    L, vs0 = 8, 3.0
    args = (torch.zeros(L, dtype=torch.float64),
            torch.full((L,), vs0 * np.sqrt(3.0), dtype=torch.float64),
            torch.full((L,), vs0, dtype=torch.float64),
            torch.full((L,), 2.7, dtype=torch.float64),
            torch.zeros(L, dtype=torch.float64))
    per = torch.tensor([5.0, 10.0, 20.0, 50.0], dtype=torch.float64)
    cfg = SurfConfig(nmodes=1, atten=False, flat=False)
    ell, c, ok = surf_ellipticity(*args, per, 2, cfg=cfg)
    ell = np.abs(ell.numpy()[:, 0])
    assert ok.all()
    np.testing.assert_allclose(c.numpy()[:, 0], 0.9194 * vs0, rtol=2e-3)
    assert ell.std() / ell.mean() < 1e-3
    assert abs(ell.mean() - 0.681) < 0.02
    amp, _, ok_a = surf_amplitude(*args, per, 2, cfg=cfg)
    amp = amp.numpy()[:, 0]
    assert ok_a.all() and (amp > 0).all()
    assert amp.std() / amp.mean() < 1e-3

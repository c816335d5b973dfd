"""Port parity of the thermal conversions beside the Cascadia stack's.

Each function — ``_log_quad``, ``jackson_faul``, ``bass_vs``,
``stix_vs``, ``pm13_vs``, ``behn2009_shear`` — and each class —
``OceanSeisYaTa`` (both solidi), ``OceanSeisJack``, ``OceanSeisPM13``,
``OceanSeisBass``, ``OceanSeisStix``, ``OceanSeisYaTa_unrelaxed``,
``OceanSeisRuan_old`` (damp True / False / numeric, YaTaJu) — against
the JAX package's on the same seeded (T, P, depth) grids, float64, to
1e-12 relative: both evaluate the same closed forms and the same fixed
64-node quadrature, so only the libm's last bits differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysurfinv_tpu.models import thermal as jt
from pysurfinv_tpu_torch.models import thermal as tt

RTOL = 1e-12


def _grid(seed=0, n=64):
    """Seeded mantle-like (T [K], P [Pa], z [km]) samples, and rho."""
    rng = np.random.default_rng(seed)
    z = np.sort(rng.uniform(5.0, 200.0, n))
    T = 600.0 + 1000.0 * rng.random(n) + 2.0 * z
    P = jt.pressure(z)
    rho = np.asarray(jt.thermal_density(P, T))
    return T, np.asarray(P), z, rho


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=0)


def test_log_quad_matches_jax():
    rng = np.random.default_rng(1)
    lo = 10.0 ** rng.uniform(-6, -1, 8)
    hi = lo * 10.0 ** rng.uniform(1, 8, 8)
    f_j = lambda t: t**0.3 / (1 + t**2)  # noqa: E731
    ref = jt._log_quad(f_j, jnp.asarray(lo), jnp.asarray(hi))
    got = tt._log_quad(f_j, torch.tensor(lo), torch.tensor(hi))
    _close(got, ref)


@pytest.mark.parametrize("gs,period", [(1e-3, 1.0), (5e-3, 50.0)])
def test_jackson_faul_matches_jax(gs, period):
    T, P, _, _ = _grid(2)
    ref = jt.jackson_faul(jnp.asarray(T), jnp.asarray(P), gs, period)
    got = tt.jackson_faul(torch.tensor(T), torch.tensor(P), gs, period)
    for a, b in zip(got, ref):
        _close(a, b)


def test_simple_conversions_match_jax():
    T, P, z, rho = _grid(3)
    j = [jnp.asarray(x) for x in (T, P, z, rho)]
    t = [torch.tensor(x) for x in (T, P, z, rho)]
    _close(tt.bass_vs(t[0], t[1], t[3]), jt.bass_vs(j[0], j[1], j[3]))
    _close(tt.stix_vs(t[0], t[2]), jt.stix_vs(j[0], j[2]))
    for period in (1.0, 100.0):
        _close(tt.pm13_vs(t[0], t[1], t[3], period),
               jt.pm13_vs(j[0], j[1], j[3], period))
    # behn2009 takes T in C and P in GPa
    for a, b in zip(tt.behn2009_shear(0.02, 1e-2, t[0] - 273.15, t[1] / 1e9),
                    jt.behn2009_shear(0.02, 1e-2, j[0] - 273.15, j[1] / 1e9)):
        _close(a, b)
    assert tt.behn2009Shear is tt.behn2009_shear


CLASSES = [
    ("OceanSeisYaTa", {}, ("vs", "qs", "vs_unrelaxed")),
    ("OceanSeisYaTa", {"Tm": "Ruan2018", "period": 20},
     ("vs", "qs", "vs_unrelaxed")),
    ("OceanSeisJack", {"gs": 2e-3, "period": 30},
     ("vs", "qs", "vs_no_anelastic")),
    ("OceanSeisPM13", {"period": 10}, ("vs",)),
    ("OceanSeisBass", {}, ("vs",)),
    ("OceanSeisStix", {}, ("vs",)),
    ("OceanSeisYaTa_unrelaxed", {}, ("vs",)),
    ("OceanSeisRuan_old", {}, ("vs", "qs", "vs_no_anelastic")),
    ("OceanSeisRuan_old", {"damp": False, "YaTaJu": True},
     ("vs", "qs", "vs_no_anelastic")),
    ("OceanSeisRuan_old", {"damp": 1600.0}, ("vs", "qs", "vs_no_anelastic")),
]


@pytest.mark.parametrize("name,kw,fields", CLASSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CLASSES)])
def test_thermal_classes_match_jax(name, kw, fields):
    ages = (0.5, 4.0, 9.0)
    for age in ages:
        z = np.linspace(0.0, 200.0, 101)
        ref = getattr(jt, name)(jt.HSCM(age, zdeps=jnp.asarray(z)), **kw)
        got = getattr(tt, name)(tt.HSCM(age, zdeps=torch.tensor(z)), **kw)
        _close(got.zdeps, ref.zdeps)
        for f in fields:
            a, b = getattr(got, f), getattr(ref, f)
            assert torch.is_tensor(a) and a.dtype == torch.float64
            assert np.isfinite(a.numpy()).all()
            _close(a, b)

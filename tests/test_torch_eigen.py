"""Port parity of the eigenfunction machinery (``ops/eigen.py``), float64
on the CPU.

* The system matrices and the halfspace basis (``_psv_system``,
  ``_sh_system``, ``_fluid_system4``, ``_psv_halfspace_basis``) against
  the JAX package's, elementwise, 1e-12 relative.
* At identical roots (the JAX solve's, passed as ``c_given``):
  ``energy_integrals`` I0-I3, ``u_int`` and ``c_var`` within 1e-9
  relative, the Lagrangian ``flagr`` and the water partials ``I*_wat``
  within 1e-9 of their scale (omega^2 I0 and I0 — flagr is a residual
  that vanishes at a root); ``eigenfunctions_regular`` (nz 100) within
  1e-8 of each profile's max.
* End to end, with the roots from each package's own solve:
  ``eigenfunctions``, ``energy_integrals`` and ``eigenfunctions_regular``
  within 1e-6 (of each profile's max, relative for the integrals).  The
  JAX side's integrals and regular-grid fields are those at its own
  roots: the same call with ``c_given`` set to the roots of its own
  solve, which shares the compile of the identical-roots oracle (only
  ``u`` differs: ``energy_integrals`` returns zeros for it with
  ``c_given``, so the port's ``u`` is held against JAX's
  ``eigenfunctions`` one).

Rayleigh and Love, ``nmodes=2`` (so mode 0 and the first overtone), T =
10, 30, 60 s, on the TEST1 eus model and under a 2 km water layer, which
exercises the impedance ``tzz``, the water partials and ``in_water``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import with_water_top

from pysurfinv_tpu.ops import dispersion as jd
from pysurfinv_tpu.ops import eigen as je
from pysurfinv_tpu_torch.ops import eigen as te
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig

torch.set_num_threads(1)

KEYS = ("h", "vp", "vs", "rho", "qsinv")
PERIODS = np.array([10.0, 30.0, 60.0])
NZ = 100
PROFILES = {"rayleigh": ("ur", "uz", "szr", "szz"), "love": ("ut", "szt")}
REGULAR = {"rayleigh": ("v1", "dv1", "v2", "dv2"), "love": ("v1", "dv1")}
INTEGRALS = {"rayleigh": ("I0", "I1", "I2", "I3", "u_int", "c_var"),
             "love": ("I0", "I1", "I2", "u_int", "c_var")}
WATER = ("I0_wat", "I1_wat", "I2_wat", "I3_wat")


def test_system_matrices_match_jax():
    """The A&R system matrices and the halfspace basis, elementwise, on
    random material in the regimes the solver meets (c below, between
    and above the P and S velocities)."""
    rng = np.random.default_rng(3)
    n = 64
    a = rng.uniform(1.4, 9.0, n)
    b = a / rng.uniform(1.6, 2.2, n)
    rho = rng.uniform(1.0, 3.6, n)
    om = 2 * np.pi / rng.uniform(5.0, 100.0, n)
    k = om / (b * rng.uniform(0.6, 0.99, n))
    t = lambda x: torch.tensor(x)  # noqa: E731
    cases = [
        (je._psv_system, te._psv_system, (k, om, a, b, rho)),
        (je._sh_system, te._sh_system, (k, om, b, rho)),
        (je._fluid_system4, te._fluid_system4, (k, om, a, rho)),
    ]
    for fj, ft, args in cases:
        ref = np.asarray(jax.vmap(fj)(*map(jnp.asarray, args)))
        out = ft(*map(t, args)).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=0)
    vpj, vsj = jax.vmap(je._psv_halfspace_basis)(
        *map(jnp.asarray, (k, om, a, b, rho)))
    vpt, vst = te._psv_halfspace_basis(*map(t, (k, om, a, b, rho)))
    np.testing.assert_allclose(vpt.numpy(), np.asarray(vpj), rtol=1e-12)
    np.testing.assert_allclose(vst.numpy(), np.asarray(vsj), rtol=1e-12)


@pytest.fixture(scope="module")
def models(eus_model):
    m = eus_model
    batch = with_water_top(tuple(np.asarray(m[k])[None] for k in KEYS)
                           + (np.array([m["nlay"]]),))
    water = {k: batch[i][1] for i, k in enumerate(KEYS)}
    water["nlay"] = int(batch[5][1])
    return {"eus": m, "water": water}


@pytest.fixture(scope="module")
def jax_eigen(models):
    """JAX's eigenfunctions at its own roots, and its integrals and
    regular-grid fields at the same roots; once per (wave, model), one
    compile per wave (``nlay`` is traced)."""
    cache = {}

    def get(wave, name):
        if (wave, name) not in cache:
            m = models[name]
            args = [jnp.asarray(m[k]) for k in KEYS]
            per, cfg = jnp.asarray(PERIODS), jd.SurfConfig(nmodes=2)
            eig = je.eigenfunctions(*args, per, m["nlay"], wave=wave, cfg=cfg)
            cg = eig["c"]
            ints = je.energy_integrals(*args, per, m["nlay"], wave=wave,
                                       cfg=cfg, c_given=cg)
            reg = je.eigenfunctions_regular(*args, per, m["nlay"], wave=wave,
                                            cfg=cfg, nz=NZ, c_given=cg)
            cache[(wave, name)] = tuple(
                {k: np.asarray(v) for k, v in d.items()}
                for d in (eig, ints, reg))
        return cache[(wave, name)]
    return get


def _port_args(m):
    return ([torch.tensor(np.asarray(m[k], np.float64)) for k in KEYS]
            + [torch.tensor(PERIODS), m["nlay"]])


def _profile_err(out, ref, name):
    o = out[name].numpy() if torch.is_tensor(out[name]) else out[name]
    assert o.shape == ref[name].shape, name
    assert np.isfinite(o).all(), name
    return np.abs(o - ref[name]).max() / np.abs(ref[name]).max()


def _check_integrals(out, ref, wave, tol):
    np.testing.assert_array_equal(out["valid"].numpy(), ref["valid"])
    assert ref["valid"].all()
    np.testing.assert_allclose(out["c"].numpy(), ref["c"], rtol=1e-12)
    for name in INTEGRALS[wave]:
        np.testing.assert_allclose(out[name].numpy(), ref[name], rtol=tol,
                                   atol=0, err_msg=name)
    om2I0 = (2 * np.pi / PERIODS[:, None]) ** 2 * ref["I0"]
    assert (np.abs(out["flagr"].numpy() - ref["flagr"]) <= tol * om2I0).all()
    if wave == "rayleigh":
        for name in WATER:
            d = np.abs(out[name].numpy() - ref[name])
            assert (d <= tol * ref["I0"]).all(), name


@pytest.mark.parametrize("model", ["eus", "water"])
@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_energy_integrals_at_identical_roots(models, jax_eigen, wave, model):
    _, ints, _ = jax_eigen(wave, model)
    out = te.energy_integrals(*_port_args(models[model]), wave=wave,
                              cfg=SurfConfig(nmodes=2),
                              c_given=torch.tensor(ints["c"]))
    assert (out["u"] == 0).all()
    _check_integrals(out, ints, wave, 1e-9)
    if wave == "rayleigh":
        wet = np.abs(ints["I0_wat"]) > 0
        assert wet.all() if model == "water" else not wet.any()


@pytest.mark.parametrize("model", ["eus", "water"])
@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_regular_grid_at_identical_roots(models, jax_eigen, wave, model):
    _, ints, reg = jax_eigen(wave, model)
    out = te.eigenfunctions_regular(*_port_args(models[model]), wave=wave,
                                    cfg=SurfConfig(nmodes=2), nz=NZ,
                                    c_given=torch.tensor(ints["c"]))
    for name in REGULAR[wave]:
        assert _profile_err(out, reg, name) <= 1e-8, name
    for name in ("mask", "in_water", "valid"):
        np.testing.assert_array_equal(out[name].numpy(), reg[name])
    np.testing.assert_array_equal(out["z"].numpy(), reg["z"])
    assert reg["in_water"].any() == (model == "water")


@pytest.mark.parametrize("model", ["eus", "water"])
@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_end_to_end_own_roots(models, jax_eigen, wave, model):
    eig, ints, reg = jax_eigen(wave, model)
    args = _port_args(models[model])
    cfg = SurfConfig(nmodes=2)

    out = te.eigenfunctions(*args, wave=wave, cfg=cfg)
    np.testing.assert_array_equal(out["valid"].numpy(), eig["valid"])
    for name in ("c", "u", "z") + PROFILES[wave]:
        assert _profile_err(out, eig, name) <= 1e-6, name
    if wave == "rayleigh":
        # unit uz at the top of the solid stack (the interface under
        # water, where szz = tzz uz carries the water column's impedance)
        top = 1 if model == "water" else 0
        np.testing.assert_allclose(out["uz"].numpy()[..., top], 1.0,
                                   atol=1e-12)

    own = te.energy_integrals(*args, wave=wave, cfg=cfg)
    np.testing.assert_allclose(own["u"].numpy(), eig["u"], rtol=1e-6)
    _check_integrals(own, ints, wave, 1e-6)

    out = te.eigenfunctions_regular(*args, wave=wave, cfg=cfg, nz=NZ)
    np.testing.assert_allclose(out["u"].numpy(), reg["u"], rtol=1e-6)
    for name in REGULAR[wave]:
        assert _profile_err(out, reg, name) <= 1e-6, name
    np.testing.assert_array_equal(out["in_water"].numpy(), reg["in_water"])

"""Port parity of the tree-product secular functions
(``pysurfinv_tpu_torch/ops/secular_assoc.py``) and of the single-model
solve on them (``SurfConfig(backend="xla_assoc")``).

The port keeps the JAX module's order of association and renormalisation
points, so its tree equals JAX's tree to rounding (measured 9.7e-13
relative on TEST1's eus model), not only up to a positive scale; against
the port's own sequential recursion only the signs and the tangent ratio
F_T/F_c are meaningful (tests/test_secular_assoc.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysurfinv_tpu.ops import secular_assoc as jax_assoc
from pysurfinv_tpu.ops.dispersion import SurfConfig as JaxSurfConfig
from pysurfinv_tpu.ops.dispersion import _model_at_period as jax_model_at
from pysurfinv_tpu.ops.dispersion import surf_forward as jax_surf_forward
from pysurfinv_tpu.ops.flatten import model_preamble as jax_preamble
from pysurfinv_tpu.ops.secular import effective_halfspace as jax_halfspace
from pysurfinv_tpu_torch.ops import secular, secular_assoc
from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _model_at_period,
                                                surf_forward)
from pysurfinv_tpu_torch.ops.flatten import model_preamble

torch.set_num_threads(1)

C_GRID = np.linspace(2.8, 4.8, 101)
PERIODS = (10.0, 40.0, 100.0)


@pytest.fixture(scope="module")
def prepared(eus_model):
    """Each package's attenuated + flattened model at a period, float64."""
    m = eus_model
    keys = ("h", "vp", "vs", "rho", "qsinv")
    jm = [jnp.asarray(m[k]) for k in keys]
    tm = [torch.tensor(m[k]) for k in keys]
    _, jfac = jax_preamble(jm[0], m["nlay"], 2, True)
    _, tfac = model_preamble(tm[0], torch.tensor(m["nlay"]), 2, True)

    def at(t):
        return (jax_model_at(jnp.asarray(t), *jm[1:], jfac, JaxSurfConfig()),
                _model_at_period(torch.tensor(t, dtype=torch.float64),
                                 *tm[1:], tfac, SurfConfig()))

    return at, m["nlay"]


def _forms(wave):
    """(JAX tree, port tree, port sequential), each F(c, t, mdl, mm)."""
    if wave == "rayleigh":
        return (lambda c, t, mdl, mm: jax_assoc.rayleigh_secular_assoc(
                    c, t, *mdl, mm),
                lambda c, t, mdl, mm: secular_assoc.rayleigh_secular_assoc(
                    c, t, *mdl, mm),
                lambda c, t, mdl, mm: secular.rayleigh_secular(
                    c, t, *mdl, mm))
    return (lambda c, t, mdl, mm: jax_assoc.love_secular_assoc(
                c, t, *mdl[1:], mm),
            lambda c, t, mdl, mm: secular_assoc.love_secular_assoc(
                c, t, *mdl[1:], mm),
            lambda c, t, mdl, mm: secular.love_secular(c, t, *mdl[1:], mm))


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_tree_matches_jax_tree(prepared, wave):
    """At T = 10/40/100 s over 101 c in [2.8, 4.8] km/s: the port's tree
    equals JAX's to 1e-10 relative (measured 9.7e-13), the closure layers
    are JAX's, the signs are those of the port's sequential recursion, and
    F_T/F_c at the first sign change matches JAX's tree and the port's
    sequential form to rtol 1e-6 (tests/test_secular_assoc.py's bound)."""
    at, nlay = prepared
    jtree, ttree, tseq = _forms(wave)
    n = len(C_GRID)

    @jax.jit
    def jax_values(cs, t, mdl):
        mm = jax.vmap(lambda c: jax_halfspace(c, t, mdl[1], mdl[3], nlay,
                                              4.0))(cs)
        return jax.vmap(lambda c, m: jtree(c, t, mdl, m))(cs, mm), mm

    @jax.jit
    def jax_ratio(c0, t, mdl, mm0):
        _, fc = jax.jvp(lambda cc: jtree(cc, t, mdl, mm0), (c0,),
                        (jnp.ones_like(c0),))
        _, ft = jax.jvp(lambda tt: jtree(c0, tt, mdl, mm0), (t,),
                        (jnp.ones_like(t),))
        return ft / fc

    for t in PERIODS:
        jmdl, tmdl = at(t)
        f_j, mm_j = map(np.asarray, jax_values(jnp.asarray(C_GRID),
                                               jnp.asarray(t), jmdl))
        c_t = torch.tensor(C_GRID)
        t_t = torch.full((n,), t, dtype=torch.float64)
        mm_t = secular.effective_halfspace(c_t, t_t, tmdl[1], tmdl[3], nlay)
        np.testing.assert_array_equal(mm_t.numpy(), np.asarray(mm_j))
        mdl_b = [x.expand(n, x.shape[-1]) for x in tmdl]
        f_t = ttree(c_t, t_t, mdl_b, mm_t).numpy()
        f_s = tseq(c_t, t_t, mdl_b, mm_t).numpy()
        np.testing.assert_allclose(f_t, f_j, rtol=1e-10, atol=0)
        assert (np.sign(f_t) == np.sign(f_s)).all(), (
            f"{wave} T={t}: sign mismatch at "
            f"{C_GRID[np.sign(f_t) != np.sign(f_s)]}")

        # the tangent ratio F_T/F_c near the first sign change
        i = int(np.argmax(np.sign(f_t)[:-1] != np.sign(f_t)[1:]))
        c0, mm0_t = C_GRID[i], mm_t[i]

        def ratio_port(F):
            c_ = torch.tensor(c0, dtype=torch.float64, requires_grad=True)
            t_ = torch.tensor(t, dtype=torch.float64, requires_grad=True)
            fc, ft = torch.autograd.grad(F(c_, t_, tmdl, mm0_t), (c_, t_))
            return float(ft / fc)

        r_j = float(jax_ratio(jnp.asarray(c0), jnp.asarray(t), jmdl,
                              jnp.asarray(mm_j[i])))
        np.testing.assert_allclose(ratio_port(ttree), r_j, rtol=1e-6)
        np.testing.assert_allclose(ratio_port(tseq), r_j, rtol=1e-6)


def test_surf_forward_xla_assoc_matches_jax(eus_model):
    """``surf_forward(cfg=SurfConfig(backend="xla_assoc"))`` on TEST1's
    eus model, 6 periods, Rayleigh: roots within 1e-9 km/s of JAX's
    ``xla_assoc`` solve (the group velocity to 1e-7 km/s), every root
    found; within 5e-5 km/s (c) and 4e-3 km/s (u) of the port's
    sequential solve, the bounds of tests/test_secular_assoc.py."""
    m = eus_model
    keys = ("h", "vp", "vs", "rho", "qsinv")
    periods = np.asarray(m["periods"], float)[:6]
    cj, uj, okj = map(np.asarray, jax_surf_forward(
        *(jnp.asarray(m[k]) for k in keys), jnp.asarray(periods), m["nlay"],
        wave="rayleigh", cfg=JaxSurfConfig(backend="xla_assoc")))
    args = [torch.tensor(m[k]) for k in keys]
    out = {bk: surf_forward(*args, torch.tensor(periods), m["nlay"],
                            wave="rayleigh", cfg=SurfConfig(backend=bk))
           for bk in ("auto", "xla_assoc")}
    c1, u1, ok1 = (x.numpy() for x in out["xla_assoc"])
    c0, u0, ok0 = (x.numpy() for x in out["auto"])
    assert ok1.all() and okj.all() and ok0.all()
    np.testing.assert_allclose(c1, cj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(u1, uj, rtol=0, atol=1e-7)
    np.testing.assert_allclose(c1, c0, rtol=0, atol=5e-5)
    np.testing.assert_allclose(u1, u0, rtol=0, atol=4e-3)

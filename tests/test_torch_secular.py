"""Port parity: flattening, the eager secular functions and the plain
versions of the three secular-lane kernels, against the JAX package.

Same numpy inputs to both packages.  The eager path runs in float64
(rtol 1e-10); the lane kernels' plain versions run in float32 against
the JAX Pallas kernels in interpret mode, with the tolerances of the
kernel contract: |dF| <= 1e-4 * max_k |F| per model column with equal
signs above that bound, b_hs to rtol 1e-6, mm exactly, F_T/F_c to 2e-3
relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import eus_batch, with_water_top

from pysurfinv_tpu.ops import flatten as jflat
from pysurfinv_tpu.ops import pallas_secular as jps
from pysurfinv_tpu.ops import secular as jsec
from pysurfinv_tpu_torch.ops import flatten as tflat
from pysurfinv_tpu_torch.ops import secular as tsec
from pysurfinv_tpu_torch.ops import secular_lanes as tsl

torch.set_num_threads(1)

WAVES = ["rayleigh", "love"]
# probes of tests/test_pallas_secular.py:69-72 (evanescent/oscillatory),
# plus a fourth column for the water-top model (liquid regime)
PERIODS = [10.0, 25.0, 60.0, 100.0]
PROBES = np.array([[3.0, 3.4, 4.1, 2.9], [3.2, 3.9, 4.4, 3.3],
                   [3.6, 4.05, 4.6, 3.7], [3.8, 4.3, 4.9, 4.0]])


@pytest.fixture(scope="module")
def batch32(eus_model):
    return with_water_top(eus_batch(eus_model))


def _flat(batch, kind):
    h, _, _, _, _, nlay = batch
    return jax.vmap(jflat.flatten_factors, in_axes=(0, 0, None))(
        jnp.asarray(h), jnp.asarray(nlay), kind)


def test_flatten_matches_jax_f64(eus_model):
    h, _, _, _, _, nlay = with_water_top(eus_batch(eus_model,
                                                   dtype=np.float64))
    h[1, 3] = 5e-4  # one thin layer
    for kind in (1, 2):
        for flat in (True, False):
            jh, jf = jax.vmap(jflat.model_preamble,
                              in_axes=(0, 0, None, None))(
                jnp.asarray(h), jnp.asarray(nlay), kind, flat)
            th, tf = tflat.model_preamble(torch.tensor(h), torch.tensor(nlay),
                                          kind, flat)
            for a, b in zip((jh, *jf), (th, *tf)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-10, atol=1e-12)


def _model_at(batch, ib, T, kind, dtype):
    """Attenuated + flattened (a, b, rho, d) of model ib at period T."""
    h, vp, vs, rho, qsi, nlay = batch
    fac = jflat.flatten_factors(jnp.asarray(h[ib]), int(nlay[ib]), kind)
    fac = [np.asarray(x) for x in fac]
    a, b = jsec.attenuation_rescale(jnp.asarray(vp[ib]), jnp.asarray(vs[ib]),
                                    jnp.asarray(qsi[ib]), dtype(T))
    ta, tb = tsec.attenuation_rescale(
        torch.tensor(vp[ib]), torch.tensor(vs[ib]), torch.tensor(qsi[ib]),
        torch.tensor(dtype(T)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(a), rtol=1e-12)
    np.testing.assert_allclose(tb.numpy(), np.asarray(b), rtol=1e-12)
    return (np.asarray(a) * fac[1], np.asarray(b) * fac[1],
            rho[ib] * fac[2], fac[0])


@pytest.mark.parametrize("wave", WAVES)
def test_eager_secular_matches_jax_f64(eus_model, wave):
    """rayleigh_secular / love_secular / effective_halfspace, float64."""
    batch = with_water_top(eus_batch(eus_model, dtype=np.float64))
    kind = 1 if wave == "love" else 2
    B = batch[0].shape[0]
    mdl = np.stack([np.stack([np.stack(_model_at(batch, ib, T, kind,
                                                 np.float64))
                              for ib in range(B)]) for T in PERIODS])
    a, b, rho, d = (mdl[:, :, i] for i in range(4))          # (K, B, L)
    t = np.broadcast_to(np.array(PERIODS)[:, None], PROBES.shape)
    nl = np.broadcast_to(batch[5][None], PROBES.shape)

    jf = jax.vmap(jsec.effective_halfspace, in_axes=(0, 0, 0, 0, 0))
    mm_j = np.asarray(jf(*(jnp.asarray(x.reshape((-1,) + x.shape[2:]))
                           for x in (PROBES, t, b, d, nl)))).reshape(t.shape)
    mm_t = tsec.effective_halfspace(torch.tensor(PROBES), torch.tensor(t),
                                    torch.tensor(b), torch.tensor(d),
                                    torch.tensor(nl)).numpy()
    np.testing.assert_array_equal(mm_t, mm_j)

    flat = lambda x: jnp.asarray(x.reshape((-1,) + x.shape[2:]))  # noqa
    if wave == "rayleigh":
        fj = jax.vmap(jsec.rayleigh_secular)(
            flat(PROBES), flat(t), flat(a), flat(b), flat(rho), flat(d),
            flat(mm_j))
        ft = tsec.rayleigh_secular(*(torch.tensor(np.ascontiguousarray(x))
                                     for x in (PROBES, t, a, b, rho, d)),
                                   torch.tensor(mm_t))
    else:
        fj = jax.vmap(jsec.love_secular)(
            flat(PROBES), flat(t), flat(b), flat(rho), flat(d), flat(mm_j))
        ft = tsec.love_secular(*(torch.tensor(np.ascontiguousarray(x))
                                 for x in (PROBES, t, b, rho, d)),
                               torch.tensor(mm_t))
    fj = np.asarray(fj).reshape(t.shape)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-10,
                               atol=1e-12 * np.abs(fj).max())


def _lanes(batch, wave):
    """Lane inputs of the JAX kernels and the port's plain versions: the
    same float32 arrays, flattening factors computed once."""
    h, vp, vs, rho, qsi, nlay = batch
    fac = _flat(batch, 1 if wave == "love" else 2)
    model = [np.ascontiguousarray(np.asarray(x).T)
             for x in (vp, vs, rho, qsi, *fac)]
    c = PROBES.astype(np.float32)
    t = np.ascontiguousarray(np.broadcast_to(
        np.array(PERIODS, np.float32)[:, None], c.shape))
    return c, t, model, nlay


def _both(fn_j, fn_t, c, t, mm, model, nlay, wave, **kw):
    out_j = fn_j(jnp.asarray(c), jnp.asarray(t), jnp.asarray(mm),
                 *map(jnp.asarray, model), jnp.asarray(nlay), wave=wave,
                 interpret=True, **kw)
    out_t = fn_t(torch.tensor(c), torch.tensor(t), torch.tensor(mm),
                 *map(torch.tensor, model), torch.tensor(nlay), wave=wave,
                 **kw)
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [np.asarray(x) for x in out_j], [x.numpy() for x in out_t]


def _assert_F(Ft, Fj):
    bound = 1e-4 * np.abs(Fj).max(axis=0, keepdims=True)
    assert np.all(np.abs(Ft - Fj) <= bound)
    big = np.abs(Fj) > bound
    assert np.all(np.sign(Ft[big]) == np.sign(Fj[big]))


@pytest.mark.parametrize("wave", WAVES)
def test_plain_lanes_match_jax_kernels(batch32, wave):
    """The three plain versions against the Pallas kernels (interpret)."""
    c, t, model, nlay = _lanes(batch32, wave)
    zero = np.zeros(c.shape, np.int32)

    # kernel 1: dynamic truncation
    (Fj, bj, mj), (Ft, bt, mt) = _both(jps.secular_lanes, tsl.secular_lanes,
                                       c, t, zero, model, nlay, wave)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(bt, bj, rtol=1e-6)
    _assert_F(Ft, Fj)
    mm_dyn = mj

    # kernel 1 with a pinned closure layer (tests/test_pallas_secular.py:111)
    pin = np.full(c.shape, 12, np.int32)
    (Fj, bj, mj), (Ft, bt, mt) = _both(jps.secular_lanes, tsl.secular_lanes,
                                       c, t, pin, model, nlay, wave)
    np.testing.assert_array_equal(mt, 12)
    np.testing.assert_array_equal(mj, 12)
    np.testing.assert_allclose(bt, bj, rtol=1e-6)
    _assert_F(Ft, Fj)

    # kernel 2 at the dynamic closure layers (the refinement's convention)
    (Fj,), (Ft,) = _both(jps.secular_lanes_frozen, tsl.secular_lanes_frozen,
                         c, t, mm_dyn, model, nlay, wave)
    _assert_F(Ft, Fj)

    # kernel 3: primal and the tangent ratio behind the group velocity
    (Fj, Fcj, Ftj), (Ft, Fct, Ftt) = _both(
        jps.secular_lanes_grad, tsl.secular_lanes_grad, c, t, mm_dyn,
        model, nlay, wave)
    _assert_F(Ft, Fj)
    rj, rt = Ftj / Fcj, Ftt / Fct
    assert np.all(np.abs(rt - rj) <= 2e-3 * np.maximum(np.abs(rj), 1e-6))


@pytest.mark.parametrize("wave", WAVES)
def test_plain_lanes_vs_eager_sign_and_ratio(batch32, wave):
    """The plain lane version against the port's eager path: the two
    renormalise at different points, so only sign(F) and the order of
    magnitude are shared (tests/test_pallas_secular.py:100-107)."""
    c, t, model, nlay = _lanes(batch32, wave)
    K, B = c.shape
    F, bhs, mm = tsl.secular_lanes_plain(
        torch.tensor(c), torch.tensor(t),
        torch.zeros(c.shape, dtype=torch.int32),
        *map(torch.tensor, model), torch.tensor(nlay), wave=wave)
    vp, vs, rho, qsi, hf, vf, rf = (torch.tensor(x.T) for x in model)
    tt = torch.tensor(t)[..., None]
    a, b = tsec.attenuation_rescale(vp, vs, qsi, tt)
    a, b, r, d = a * vf, b * vf, (rho * rf).expand(a.shape), hf.expand(a.shape)
    mm_e = tsec.effective_halfspace(torch.tensor(c), torch.tensor(t), b, d,
                                    torch.tensor(nlay))
    np.testing.assert_array_equal(mm.numpy(), mm_e.numpy())
    if wave == "rayleigh":
        Fe = tsec.rayleigh_secular(torch.tensor(c), torch.tensor(t), a, b, r,
                                   d, mm_e)
    else:
        Fe = tsec.love_secular(torch.tensor(c), torch.tensor(t), b, r, d, mm_e)
    assert torch.equal(torch.sign(F), torch.sign(Fe))
    ratio = (F.abs() / Fe.abs()).numpy()
    assert ratio.max() / ratio.min() < 1e3

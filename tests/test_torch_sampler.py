"""Port parity of the batched MCMC sampler's building blocks.

* the counter-based lane streams (threefry2x32) against ``jax.random``;
* ``CompiledModel`` profiles and prior against the JAX package's, in
  float64 on seeded thetas;
* the lanes' likelihood against the JAX package's solve and misfit;
* the port's own invariants, bitwise: the compaction pyramid equals the
  plain retry loop, segmented runs equal monolithic ones, tiled runs
  equal untiled ones.

Inputs are made with numpy from seeds and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu.inversion.compiled import CompiledModel as JaxCompiled
from pysurfinv_tpu.inversion.point import PointCascadia as JaxPoint
from pysurfinv_tpu.ops.dispersion import surf_forward_batch as jax_solve
from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg as jax_solver_cfg
from pysurfinv_tpu_torch.convert import lane_keys_from_numpy, spec_from_numpy
from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.mcmc import (ChainConfig, _propose,
                                                _propose_batched,
                                                make_batched_sampler,
                                                make_segmented_sampler)
from pysurfinv_tpu_torch.inversion.point import PointCascadia
from pysurfinv_tpu_torch.models.model1d import buildModel1D
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward_batch
from pysurfinv_tpu_torch.parallel.grid import (chi_sqr_fn, invert_grid,
                                               mcmc_solver_cfg)

torch.set_num_threads(1)

LLS = [(229.0, 46.0), (229.5, 46.0), (229.0, 46.5)]
SEDS = [0.019, 0.5, 1.0]


def _points(cls, n=2, periods=PERIODS, vels=VELS, uncers=UNCERS):
    pts = []
    for sed in SEDS[:n]:
        loc = dict(LOCAL)
        loc["sedthk"] = sed
        pts.append(cls(SETTING, loc, periods=periods, vels=vels,
                       uncers=uncers))
    return pts


def _track(outdir, lonlat):
    lon, lat = lonlat
    return np.load(f"{outdir}/{lon:g}_{lat:g}.npz",
                   allow_pickle=True)["mcTrack"]


@pytest.fixture(scope="module")
def cms():
    """(JAX, port) compiled models of the Cascadia fixture."""
    return (JaxCompiled(JaxPoint(SETTING, LOCAL, periods=PERIODS, vels=VELS,
                                 uncers=UNCERS).initMod),
            CompiledModel(buildModel1D(SETTING, LOCAL)))


def _thetas(spec, n, seed):
    """n/2 uniform draws in the bounds and n/2 near theta0."""
    rng = np.random.default_rng(seed)
    vmin, vmax = np.asarray(spec.vmin), np.asarray(spec.vmax)
    uni = vmin + rng.random((n // 2, len(vmin))) * (vmax - vmin)
    near = (np.asarray(spec.theta0)
            + 0.5 * np.asarray(spec.step) * rng.standard_normal(uni.shape))
    return np.concatenate([uni, np.clip(near, vmin, vmax)])


# ---------------------------------------------------------------------------
# (c) counter-based lane streams
# ---------------------------------------------------------------------------

def test_threefry_streams_match_jax_random():
    key = jax.random.PRNGKey(42)
    lane = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(6))
    kt = R.PRNGKey(42)
    assert torch.equal(kt, lane_keys_from_numpy(np.asarray(key),
                                                device="cpu"))
    lt = R.fold_in(kt, torch.arange(6))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lane))
    for d in (0, 7, 2 ** 31 + 5):
        np.testing.assert_array_equal(
            R.fold_in(kt, d).numpy(), np.asarray(jax.random.fold_in(key, d)))
    np.testing.assert_array_equal(
        R.split(lt, 3).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(lane)))
    np.testing.assert_array_equal(
        R.random_bits(lt, 32, (5,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5,), jnp.uint32))(
            lane)))

    lo = np.array([-1.0, -3.0, 0.2, -0.5, -2.0, -10.0, 1.0])
    hi = np.array([2.0, 0.1, 3.0, 0.5, 5.0, 10.0, 1.5])
    u_j = jax.vmap(lambda k: jax.random.uniform(k, (7,), jnp.float64))(lane)
    u_t = R.uniform(lt, (7,), torch.float64)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-12)
    z_j = jax.vmap(lambda k: jax.random.truncated_normal(
        k, lo, hi, (7,), jnp.float64))(lane)
    z_t = R.truncated_normal(lt, torch.tensor(lo), torch.tensor(hi), (7,),
                             torch.float64)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-12)
    assert ((z_t.numpy() > lo) & (z_t.numpy() < hi)).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(), (7,)])
def test_normal_matches_jax_random(dtype, shape):
    """``random.normal`` against ``jax.random.normal`` per lane key, the
    adaptive and MALA samplers' draw: rtol 1e-12 in float64 (as
    ``truncated_normal``); in float32 rtol 1e-5, the erfinv of the two
    libraries differing by up to 5.6e-6 relative in the tails (measured
    over 140,000 draws; 9.6e-7 on these 256 keys x 7)."""
    lane = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.arange(256))
    z_j = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, shape, getattr(jnp, dtype)))(lane))
    z_t = R.normal(lane_keys_from_numpy(np.asarray(lane), device="cpu"),
                   shape, getattr(torch, dtype))
    assert z_t.dtype == getattr(torch, dtype)
    assert tuple(z_t.shape) == z_j.shape == (256,) + shape
    np.testing.assert_allclose(z_t.numpy(), z_j,
                               rtol=1e-12 if dtype == "float64" else 1e-5)


# ---------------------------------------------------------------------------
# (d) the compiled model
# ---------------------------------------------------------------------------

def test_compiled_model_matches_jax(cms):
    jcm, tcm = cms
    assert (tcm.L, tcm._nfine, tcm.ntheta) == (jcm.L, jcm._nfine,
                                               jcm.ntheta)
    np.testing.assert_array_equal(tcm.psi0, np.asarray(jcm.psi0))
    for a, b in zip(tcm.spec, jcm.spec):
        np.testing.assert_array_equal(a, np.asarray(b))
    th = _thetas(jcm.spec, 64, seed=0)
    jprof = jax.jit(jax.vmap(lambda t: jcm.build_profile(t)[:5]))(th)
    jok = np.asarray(jax.jit(jax.vmap(jcm.isgood))(th))
    tprof = tcm.build_profile_batch(torch.tensor(th))
    tok = tcm.isgood(torch.tensor(th)).numpy()
    for a, b in zip(jprof, tprof[:5]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-300)
    assert (tprof[5].numpy() == tcm._n_nodes - 1).all()
    np.testing.assert_array_equal(tok, jok)
    assert 0 < tok.sum() < len(tok)  # both outcomes exercised


def test_lane_prior_matches_host_prior(cms):
    """The lane-batched prior against CascadiaOcean.isgood on the host
    (boundary cases may differ by float details, as in
    tests/test_compiled_mcmc.py:73-87)."""
    _, tcm = cms
    th = _thetas(tcm.spec, 16, seed=1)
    lane = tcm.isgood(torch.tensor(th)).numpy()
    agree = 0
    for t, ok in zip(th, lane):
        mod = tcm.model.copy()
        mod._loadMC(t)
        agree += int(bool(mod.isgood()) == bool(ok))
    assert agree >= len(th) - 1


# ---------------------------------------------------------------------------
# (f) the lanes' likelihood
# ---------------------------------------------------------------------------

def _near(spec, n, seed):
    rng = np.random.default_rng(seed)
    th = (np.asarray(spec.theta0)
          + 0.5 * np.asarray(spec.step) * rng.standard_normal((n, 6)))
    return np.clip(th, np.asarray(spec.vmin), np.asarray(spec.vmax))


def test_chi_sqr_batch_matches_jax():
    """(f) ``chi_sqr_batch`` — the lanes' profiles, one batched solve at
    the sampler's solver configuration seeded with other proposals'
    roots, the band-split misfit — against the JAX package's
    ``surf_forward_batch`` (Pallas kernels in interpret mode) and
    ``_misfit_from_c``: misfits within 1e-3 relative."""
    jp = JaxPoint(SETTING, LOCAL, periods=PERIODS, vels=VELS, uncers=UNCERS)
    tp = PointCascadia(SETTING, LOCAL, periods=PERIODS, vels=VELS,
                       uncers=UNCERS)
    jcm, tcm = JaxCompiled(jp.initMod), CompiledModel(tp.initMod)
    N = 6
    th, th_prev = _near(tcm.spec, N, 2), _near(tcm.spec, N, 3)
    T, oc, u, m = (np.repeat(x[None], N, 0) for x in tp._obs_arrays())
    ctx = tuple(torch.tensor(x) for x in
                (np.repeat(tcm.psi0[None], N, 0), T, oc, u, m))
    prev = tcm.build_profile_batch(torch.tensor(th_prev))
    c_warm, _, ok = surf_forward_batch(
        *(x.float() for x in prev[:5]), ctx[1].float(), prev[5],
        cfg=SurfConfig(nmodes=1, compute_group=False))
    c_warm = c_warm[:, :, 0]
    assert bool(ok.all())
    chi = chi_sqr_fn(tcm, PointCascadia, "rayleigh", mcmc_solver_cfg())
    mt, chit, Lt, cPt = chi(torch.tensor(th), ctx, c_warm)

    prof = jcm.build_profile_batch(jnp.asarray(th))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    c, _, ok = jax_solve(*map(f32, prof[:5]), f32(T), prof[5],
                         cfg=jax_solver_cfg()._replace(
                             backend="pallas_interpret"),
                         c_warm=jnp.asarray(c_warm.numpy()))
    cPj = jnp.where(ok[:, :, 0], c[:, :, 0], 0.0).astype(jnp.float64)
    mj, chij, Lj = jax.vmap(lambda *a: JaxPoint._misfit_from_c(
        *a, valid=a[-1]))(cPj, *map(jnp.asarray, (T, oc, u, m)))
    assert bool((cPt > 0).all()) and (np.asarray(cPj) > 0).all()
    assert np.abs(cPt.numpy() - np.asarray(cPj)).max() < 1e-4
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-3)
    np.testing.assert_allclose(chit.numpy(), np.asarray(chij), rtol=2e-3)


# ---------------------------------------------------------------------------
# (g) the port's invariants, bitwise
# ---------------------------------------------------------------------------

def test_propose_pyramid_equals_plain_loop(cms, monkeypatch):
    """Tail-compacted, wide-round proposals equal the plain retry loop
    lane for lane, for any pyramid ratio and round width
    (tests/test_compiled_mcmc.py:140-205)."""
    _, tcm = cms
    N = 96
    rng = np.random.default_rng(4)
    spec = tcm.spec
    th = (spec.theta0[None] + 0.05 * rng.standard_normal((N, tcm.ntheta))
          * spec.step[None])
    th = torch.tensor(np.clip(th, spec.vmin, spec.vmax))
    spec_b, psi_b = spec_from_numpy(
        tuple(np.repeat(f[None], N, 0) for f in spec),
        np.repeat(tcm.psi0[None], N, 0), device="cpu")
    keys = R.fold_in(R.PRNGKey(11), torch.arange(N))
    cfg = ChainConfig(chain_len=8)
    isgood = lambda t, ctx: tcm.isgood(t, ctx[0])  # noqa: E731
    ref_c, ref_f = _propose(keys, th, spec_b, (psi_b,), isgood, cfg)
    for env in ({}, {"PYSURFINV_PROPOSE_RATIO": "3"},
                {"PYSURFINV_PROPOSE_FLAT": "512"}):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            c, f = _propose_batched(keys, th, spec_b, (psi_b,), isgood, cfg,
                                    min_stage=6)
        assert torch.equal(f, ref_f) and torch.equal(c, ref_c)


def test_batched_sampler_equals_segments(cms):
    """``make_batched_sampler`` (the chain in one piece) gives the tracks
    of ``make_segmented_sampler`` run in uneven segments, bitwise; prior
    mode, so the likelihood is never called."""
    _, tcm = cms
    N, CL = 4, 7
    spec_b, psi_b = spec_from_numpy(
        tuple(np.repeat(f[None], N, 0) for f in tcm.spec),
        np.repeat(tcm.psi0[None], N, 0), device="cpu")
    keys = R.fold_in(R.PRNGKey(9), torch.arange(N))
    use_init = torch.tensor([True, False, True, False])
    cfg = ChainConfig(chain_len=CL, priori=True)
    isgood = lambda t, ctx: tcm.isgood(t, ctx[0])  # noqa: E731

    def no_solve(*_):
        raise AssertionError("prior mode evaluates no likelihood")

    whole = make_batched_sampler(isgood, no_solve, cfg)(
        keys, spec_b, (psi_b,), spec_b.theta0, use_init)
    init_fn, seg_fn = make_segmented_sampler(isgood, no_solve, cfg)
    carry = init_fn(keys, spec_b, (psi_b,), spec_b.theta0, use_init)
    rows = []
    for s0, n in ((0, 3), (3, 1), (4, 3)):
        carry, r = seg_fn(carry, keys, spec_b, (psi_b,), s0, n)
        rows.append(r)
    assert whole.shape == (N, CL, 3 + tcm.ntheta)
    assert torch.equal(whole, torch.cat(rows).transpose(0, 1))
    assert torch.equal(whole[:, 0, 3:][use_init], spec_b.theta0[use_init])
    assert len(torch.unique(whole[:, :, 3])) > N  # the chains move


def test_segments_and_tiles_do_not_change_tracks(tmp_path, monkeypatch):
    """Every draw is a pure function of (lane key, global row), and each
    lane carries its own warm roots: segmented runs (with the likelihood)
    equal the one-piece run, and tiled grids the untiled one, bitwise.
    A short period list and a 2-iteration Illinois keep the CPU solve
    cheap; the invariants do not depend on the solver."""
    monkeypatch.setenv("PYSURFINV_MCMC_NEWTON_SEP", "0")
    monkeypatch.setenv("PYSURFINV_MCMC_NBISECT", "2")
    sub = slice(0, 18, 4)
    obs = dict(periods=PERIODS[sub], vels=VELS[sub], uncers=UNCERS[sub])
    kw = dict(runN=12, chainL=6, seed=5, verbose=False, device="cpu")
    for seg in (None, 2):
        invert_grid(_points(PointCascadia, 1, **obs), LLS[:1],
                    outdir=str(tmp_path / f"s{seg}"), segment=seg, **kw)
    a, b = (_track(tmp_path / f"s{seg}", LLS[0]) for seg in (None, 2))
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and (a[:, 0] < 88888).all()
    assert 0 < a[:, 2].sum() < len(a)  # accepts and rejects

    kw.update(priori=True, runN=8, chainL=4)
    invert_grid(_points(PointCascadia, 3), LLS, outdir=str(tmp_path / "u"),
                max_lanes=None, **kw)
    invert_grid(_points(PointCascadia, 3), LLS, outdir=str(tmp_path / "t"),
                max_lanes=2, **kw)
    for ll in LLS:
        np.testing.assert_array_equal(_track(tmp_path / "u_priori", ll),
                                      _track(tmp_path / "t_priori", ll))

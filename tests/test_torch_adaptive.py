"""Port parity of the adaptive-covariance Metropolis sampler and the tuned
random walk (``pysurfinv_tpu_torch/inversion/adaptive.py``).

* Draw for draw against the JAX package: both packages' solve is replaced
  (``monkeypatch``) by one closed-form stand-in of the built profile
  (``torch_helpers.standin_solve_*``), so the chains hold the RNG folds,
  the Robbins-Monro updates, the Welford pool, the Cholesky factor, the
  ladder pick and the MH rules; the real solve is held by
  ``test_torch_sampler.py::test_chi_sqr_batch_matches_jax``.
* Mechanics with the real solve, on the port alone (as
  tests/test_adaptive.py does for the JAX package), on the CPU's plain
  versions: ~0.65 s a step with the cut solver below and ~3 s a cold
  start, so the chains are cut to 2 lanes x 8 rows.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS
from torch_helpers import standin_solve_jax, standin_solve_torch

import pysurfinv_tpu.inversion.adaptive as jax_adaptive
from pysurfinv_tpu.inversion.compiled import BrownianSpec as JaxSpec
from pysurfinv_tpu.inversion.compiled import CompiledModel as JaxCompiled
from pysurfinv_tpu.inversion.point import PointCascadia as JaxPoint
from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg as jax_solver_cfg
from pysurfinv_tpu.utils import host_eager
from pysurfinv_tpu_torch.convert import lane_keys_from_numpy, spec_from_numpy
from pysurfinv_tpu_torch.inversion import adaptive
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.point import PointCascadia, PostPoint
from pysurfinv_tpu_torch.ops import dispersion
from pysurfinv_tpu_torch.parallel.grid import mcmc_solver_cfg

torch.set_num_threads(1)

# the sampler's solver with 2 Illinois iterations seeded by the sweep's
# end values (the plain gradient version costs ~2 s a call on the CPU):
# for the mechanics tests only
CPU_SCFG = replace(mcmc_solver_cfg(), newton_sep=0, nbisect=2, fhandoff=True)


def _point(cls):
    return cls(SETTING, LOCAL, periods=PERIODS, vels=VELS, uncers=UNCERS)


@pytest.fixture
def standin(monkeypatch):
    """Both packages' samplers solve with the closed-form stand-in."""
    monkeypatch.setattr(jax_adaptive, "surf_forward_batch", standin_solve_jax)
    monkeypatch.setattr(jax_adaptive, "_TRWM_PROGRAMS", {})
    monkeypatch.setattr(dispersion, "surf_forward_batch", standin_solve_torch)


def _lanes(n, seed):
    """The JAX package's lanes of the Cascadia point (spec, context, keys,
    use_init: lane 0 from the initial model) and the same through the
    port's converters."""
    jp = _point(JaxPoint)
    with host_eager():
        jcm = JaxCompiled(jp.initMod)
        spec1, psi1 = jcm.spec_of(jp.initMod), jcm.psi_of(jp.initMod)
    rep = lambda x: np.repeat(np.asarray(x)[None], n, 0)  # noqa: E731
    spec, psi = tuple(rep(f) for f in spec1), rep(psi1)
    obs = [rep(x) for x in jp._obs_arrays()]
    keys = np.asarray(jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(seed), i))(jnp.arange(n)))
    use_init = np.arange(n) == 0
    jargs = (jnp.asarray(keys), JaxSpec(*map(jnp.asarray, spec)),
             (jnp.asarray(psi), *map(jnp.asarray, obs)))
    spec_t, psi_t = spec_from_numpy(spec, psi, device="cpu")
    targs = (lane_keys_from_numpy(keys, device="cpu"), spec_t,
             (psi_t, *map(torch.tensor, obs)))
    return (jcm, jargs, jnp.asarray(use_init)), (
        CompiledModel(_point(PointCascadia).initMod), targs,
        torch.tensor(use_init))


def _assert_rows_match(rows_t, rows_j):
    """Accept columns equal; thetas, misfits and L to 1e-10 relative (L
    = exp(-chi/2) may underflow to subnormals, which XLA flushes to 0)."""
    rows_t, rows_j = np.asarray(rows_t), np.asarray(rows_j)
    assert rows_t.shape == rows_j.shape
    np.testing.assert_array_equal(rows_t[..., 2], rows_j[..., 2])
    np.testing.assert_allclose(rows_t[..., 3:], rows_j[..., 3:], rtol=1e-10)
    np.testing.assert_allclose(rows_t[..., 0], rows_j[..., 0], rtol=1e-10)
    np.testing.assert_allclose(rows_t[..., 1], rows_j[..., 1], rtol=1e-10,
                               atol=1e-300)
    acc = rows_t[1:, :, 2]
    assert 0 < acc.mean() < 1, "the chains should accept and reject"


def test_am_tracks_match_jax(standin):
    """``make_adaptive_sampler`` on 4 lanes, warmups 4/8/4, chain_len 8:
    the frozen Cholesky factor and scale to 1e-10 relative, and the
    recorded rows draw for draw (accepts equal, the rest to 1e-10)."""
    (jcm, jargs, juse), (tcm, targs, tuse) = _lanes(4, seed=5)
    kw = dict(warmup1=4, warmup2=8, warmup3=4, chain_len=8)
    ji, jw, jr = jax_adaptive.make_adaptive_sampler(
        jcm, JaxPoint, jax_solver_cfg(), "rayleigh",
        jax_adaptive.AdaptConfig(**kw))
    carry = jax.jit(ji)(*jargs, jargs[1].theta0, juse)
    carry, chol_j, scale_j = jax.jit(jw)(carry, *jargs)
    _, rows_j = jax.jit(jr)(carry, *jargs, chol_j, scale_j)

    ti, tw, tr = adaptive.make_adaptive_sampler(
        tcm, PointCascadia, mcmc_solver_cfg(), "rayleigh",
        adaptive.AdaptConfig(**kw))
    carry = ti(*targs, targs[1].theta0, tuse)
    carry, chol_t, scale_t = tw(carry, *targs)
    _, rows_t = tr(carry, *targs, chol_t, scale_t)

    np.testing.assert_allclose(chol_t.numpy(), np.asarray(chol_j),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(float(scale_t), float(scale_j), rtol=1e-10)
    _assert_rows_match(rows_t, rows_j)


def test_tuned_rwm_tracks_match_jax(standin, tmp_path):
    """``tuned_rwm_point`` (runN 16 / chainL 8, 6 warm lanes, std_steps 8,
    rm_steps 4): the npz track draw for draw against the JAX package's,
    so the phase-1 stds, the ladder and its pick agree."""
    kw = dict(pid="t", runN=16, chainL=8, seed=3, std_steps=8, rm_steps=4,
              warm_lanes=6)
    pj = jax_adaptive.tuned_rwm_point(_point(JaxPoint),
                                      outdir=str(tmp_path / "j"), **kw)
    pt = adaptive.tuned_rwm_point(_point(PointCascadia),
                                  outdir=str(tmp_path / "t"), device="cpu",
                                  **kw)
    a = np.load(pj, allow_pickle=True)["mcTrack"]
    b = np.load(pt, allow_pickle=True)["mcTrack"]
    assert b.shape == a.shape == (16, 9)
    _assert_rows_match(b.reshape(2, 8, 9).transpose(1, 0, 2),
                       a.reshape(2, 8, 9).transpose(1, 0, 2))


def _jax_pick(cand, accs, target_acc):
    """The JAX package's inline pick (inversion/adaptive.py:457-463)."""
    ll = np.log(cand)
    if accs[0] <= target_acc:
        return float(cand[0])
    if accs[-1] >= target_acc:
        return float(cand[-1])
    return float(np.exp(np.interp(-target_acc, -accs, ll)))


def test_ladder_pick():
    """On a non-increasing acceptance ladder the pick is the JAX
    package's; on a non-monotone one (a noisy rung) the running minimum
    keeps it within the ladder and at the target's crossing of the
    monotone curve, where JAX's ``np.interp`` on an unsorted axis is
    undefined (ROADMAP Queue 3)."""
    cand = 0.3 * np.power(2.0, np.arange(-1.0, 5.0))
    rng = np.random.default_rng(0)
    for _ in range(50):
        accs = np.sort(rng.random(6))[::-1]
        for target in (0.05, 0.15, 0.27, 0.6, 0.99):
            assert adaptive.ladder_pick(cand, accs, target) == \
                _jax_pick(cand, accs, target)
    accs = np.array([0.5, 0.3, 0.35, 0.1, 0.12, 0.02])
    for target in (0.01, 0.11, 0.15, 0.32, 0.6):
        lam = adaptive.ladder_pick(cand, accs, target)
        assert cand[0] <= lam <= cand[-1]
    # 0.15 crosses the running minimum [.5 .3 .3 .1 .1 .02] between the
    # second and fourth rung
    lam = adaptive.ladder_pick(cand, accs, 0.15)
    assert cand[1] < lam < cand[3]


def test_adaptive_covariance_is_learned(standin):
    """Every lane from the initial model (as tests/test_adaptive.py:62
    starts them), warmups 8/16/8 with the stand-in solve: the frozen
    proposal factor is a valid Cholesky factor (lower-triangular,
    positive diagonal), finite, with a positive scale, and carries
    off-diagonal mass: the pooled covariance learned from the chains'
    accepted moves is not diagonal.  (The JAX test asserts only ``off >=
    0``: its 4/12/4 warmup on the real solve may accept nothing.)"""
    (_, _, _), (tcm, targs, _) = _lanes(3, seed=5)
    init_fn, warmup_fn, _ = adaptive.make_adaptive_sampler(
        tcm, PointCascadia, mcmc_solver_cfg(), "rayleigh",
        adaptive.AdaptConfig(warmup1=8, warmup2=16, warmup3=8, chain_len=8))
    carry = init_fn(*targs, targs[1].theta0, torch.ones(3, dtype=torch.bool))
    _, chol, scale = warmup_fn(carry, *targs)
    chol = chol.numpy()
    assert np.isfinite(chol).all() and float(scale) > 0
    assert np.array_equal(chol, np.tril(chol))
    assert (np.diag(chol) > 0).all()
    off = np.abs(chol - np.diag(np.diag(chol))).sum()
    assert off > 0


def _check_track(path, n_rows, chain_len, distinct):
    d = np.load(path, allow_pickle=True)
    tr = d["mcTrack"]
    assert tr.shape[0] == n_rows
    assert np.isfinite(tr).all()
    # row 0 of each chain is the forced-accept start row
    assert (tr[::chain_len, 2] == 1).all()
    acc = tr[:, 2].mean()
    assert 0.0 < acc <= 1.0, f"degenerate acceptance {acc}"
    assert np.unique(np.round(tr[:, 0], 6)).size > distinct
    pp = PostPoint(path, device="cpu")
    assert np.isfinite(pp.misfits).all()


def test_adaptive_mechanics(tmp_path):
    """``adaptive_point`` with the real solve, runN 16 / chainL 8,
    warmups 1/2/1: chains in the reference npz format, every row finite,
    row 0 of each chain accepted, the misfit moves, PostPoint reads it."""
    path = adaptive.adaptive_point(
        _point(PointCascadia), outdir=str(tmp_path), pid="a", runN=16,
        chainL=8, seed=3, scfg=CPU_SCFG, device="cpu",
        acfg=adaptive.AdaptConfig(warmup1=1, warmup2=2, warmup3=1))
    _check_track(path, 16, 8, distinct=5)


def test_tuned_rwm_mechanics(tmp_path, monkeypatch):
    """``tuned_rwm_point`` with the real solve (runN 16 / chainL 8, 6 warm
    lanes, std_steps 4, rm_steps 2): the recorded chains in the npz
    format, and the frozen tuned steps (the recorded phase's diagonal
    Cholesky factor) positive and within half of each parameter's
    range."""
    frozen = []
    make = adaptive.make_adaptive_sampler

    def spy(*a, **k):
        init_fn, warmup_fn, run_fn = make(*a, **k)

        def run(carry, keys, spec_b, ctx_b, chol, scale):
            frozen.append((chol.clone(), scale))
            return run_fn(carry, keys, spec_b, ctx_b, chol, scale)
        return init_fn, warmup_fn, run

    monkeypatch.setattr(adaptive, "make_adaptive_sampler", spy)
    pt = _point(PointCascadia)
    path = adaptive.tuned_rwm_point(pt, outdir=str(tmp_path), pid="t",
                                    runN=16, chainL=8, seed=3, std_steps=4,
                                    rm_steps=2, warm_lanes=6, scfg=CPU_SCFG,
                                    device="cpu")
    _check_track(path, 16, 8, distinct=3)
    chol, scale = frozen[-1]            # the recorded phase's proposal
    step = np.diag(chol.numpy())
    assert np.array_equal(chol.numpy(), np.diag(step)) and float(scale) == 1
    spec = CompiledModel(pt.initMod).spec
    assert (step > 0).all() and (step <= 0.5 * (spec.vmax - spec.vmin)).all()

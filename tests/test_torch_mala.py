"""Port parity of the MALA sampler (``pysurfinv_tpu_torch/inversion/mala.py``).

* ``_grad_chi_lane`` — the likelihood gradient by autograd through the
  port's lane model build and the eager float64 secular function at
  frozen roots — against the JAX package's vmapped ``jax.vjp``, fed the
  same roots from one solve;
* the chains draw for draw against the JAX package with both packages'
  solve and gradient replaced by one closed-form stand-in (the stand-in
  solve of ``torch_helpers`` and its exact gradient by each package's
  AD), so the drift cap, the proposal densities, the RNG folds and the MH
  rule are held;
* mechanics with the real solve and gradient on the port alone (as
  tests/test_mala.py does for the JAX package), on the CPU's plain
  versions with the cut solver of ``test_torch_adaptive.py``.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS
from test_torch_adaptive import _lanes
from torch_helpers import standin_solve_jax, standin_solve_torch

import pysurfinv_tpu.inversion.mala as jax_mala
from pysurfinv_tpu.inversion.compiled import CompiledModel as JaxCompiled
from pysurfinv_tpu.inversion.point import PointCascadia as JaxPoint
from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg as jax_solver_cfg
from pysurfinv_tpu_torch.inversion import mala
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.point import PointCascadia, PostPoint
from pysurfinv_tpu_torch.ops import dispersion
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward_batch
from pysurfinv_tpu_torch.parallel.grid import mcmc_solver_cfg

torch.set_num_threads(1)

CPU_SCFG = replace(mcmc_solver_cfg(), newton_sep=0, nbisect=2, fhandoff=True)
TAU = 0.5


def _point(cls):
    return cls(SETTING, LOCAL, periods=PERIODS, vels=VELS, uncers=UNCERS)


def _near(spec, n, seed):
    """n thetas within half a step of theta0, clipped into the bounds."""
    rng = np.random.default_rng(seed)
    th = (spec.theta0 + 0.5 * spec.step
          * rng.standard_normal((n, len(spec.theta0))))
    return np.clip(th, spec.vmin, spec.vmax)


def _solve(tcm, th, periods):
    """Roots of the port's batched float32 solve (Illinois, no group) of
    the thetas' profiles: (N, P) float64, 0 where not found."""
    prof = tcm.build_profile_batch(torch.as_tensor(th))
    c, _, ok = surf_forward_batch(
        *(x.float() for x in prof[:5]), torch.as_tensor(periods).float(),
        prof[5], cfg=SurfConfig(nmodes=1, compute_group=False))
    return torch.where(ok[:, :, 0], c[:, :, 0], 0.0).double()


def test_grad_chi_lane_matches_jax():
    """4 lanes near theta0, float64, the same roots handed to both: the
    port's gradient equals JAX's to 1e-8 relative of each lane's largest
    component (measured 3.1e-15), every lane finite; a lane whose roots
    all failed, and one with a single failed period (its misfit is the
    88888 sentinel, flat in c), get zero gradient in both."""
    jp, tp = _point(JaxPoint), _point(PointCascadia)
    jcm, tcm = JaxCompiled(jp.initMod), CompiledModel(tp.initMod)
    N = 4
    th = _near(tcm.spec, N, seed=1)
    psi = np.repeat(tcm.psi0[None], N, 0)
    obs = [np.repeat(x[None], N, 0) for x in tp._obs_arrays()]
    cP = _solve(tcm, th, obs[0]).numpy()
    assert (cP > 0).all()
    cP[2, 5] = 0.0          # one failed period
    cP[3] = 0.0             # every period failed
    args = (th, psi, obs[0], cP, *obs[1:])

    g_t = mala._grad_chi_lane(tcm, PointCascadia, mcmc_solver_cfg(),
                              "rayleigh")(*map(torch.as_tensor, args))
    g_t = g_t.numpy()
    g_j = np.asarray(jax.jit(jax.vmap(jax_mala._grad_chi_lane(
        jcm, JaxPoint, jax_solver_cfg(), "rayleigh")))(
            *map(jnp.asarray, args)))
    assert np.isfinite(g_t).all() and np.isfinite(g_j).all()
    assert (np.abs(g_j[:2]) > 0).all()
    np.testing.assert_array_equal(g_t[2:], 0.0)
    np.testing.assert_array_equal(g_j[2:], 0.0)
    scale = np.abs(g_j[:2]).max(axis=1, keepdims=True)
    np.testing.assert_allclose(g_t[:2] / scale, g_j[:2] / scale, rtol=0,
                               atol=1e-8)


def test_mala_gradient_pulls_downhill():
    """(tests/test_mala.py:66 on the port) A pure-drift step (no noise)
    of a small tau from perturbed starts must reduce chi^2 on no lane by
    more than 1e-6 and strictly on some: the sign and scale of the
    implicit-differentiation gradient."""
    pt = _point(PointCascadia)
    cm = CompiledModel(pt.initMod)
    spec = cm.spec
    N = 4
    rng = np.random.default_rng(0)
    th = np.clip(spec.theta0 + spec.step * rng.standard_normal((N, 6)),
                 spec.vmin + 1e-9, spec.vmax - 1e-9)
    T, c_obs, unc, m_obs = (torch.as_tensor(np.repeat(x[None], N, 0))
                            for x in pt._obs_arrays())
    psi = torch.as_tensor(np.repeat(cm.psi0[None], N, 0))
    mfc = PointCascadia._misfit_from_c

    cP = _solve(cm, th, T)
    chi0 = mfc(cP, T, c_obs, unc, m_obs, valid=m_obs)[1].numpy()
    g = mala._grad_chi_lane(cm, PointCascadia, mcmc_solver_cfg(),
                            "rayleigh")(torch.as_tensor(th), psi, T, cP,
                                        c_obs, unc, m_obs).numpy()
    assert np.isfinite(g).all()
    th1 = np.clip(th - 0.25 * 0.2 ** 2 * spec.step ** 2 * g, spec.vmin,
                  spec.vmax)
    chi1 = mfc(_solve(cm, th1, T), T, c_obs, unc, m_obs,
               valid=m_obs)[1].numpy()
    assert (chi1 <= chi0 + 1e-6).all(), (chi0, chi1)
    assert (chi1 < chi0 - 1e-3).any()


def _standin_grad_jax(cm, pcls, scfg, wave):
    """The stand-in's exact d(chi)/d(theta) by jax.grad, one lane."""
    def one(theta, psi, T, c_star, obs_c, uncer, obs_m):
        def chi(th):
            h, vp, vs, rho, qsi, nlay = cm.build_profile(th, psi)
            c = standin_solve_jax(h[None], vp[None], vs[None], rho[None],
                                  qsi[None], T[None], nlay,
                                  round32=False)[0][0, :, 0]
            return pcls._misfit_from_c(c, T, obs_c, uncer, obs_m,
                                       valid=obs_m)[1]
        return jax.grad(chi)(theta)
    return one


def _standin_grad_torch(cm, pcls, scfg, wave):
    """The stand-in's exact d(chi)/d(theta) by autograd, all lanes."""
    def grad(thetas, psi, T, c_star, obs_c, uncer, obs_m):
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            prof = cm.build_profile_batch(th, psi)
            c = standin_solve_torch(*prof[:5], T, prof[5],
                                    round32=False)[0][:, :, 0]
            chi = pcls._misfit_from_c(c, T, obs_c, uncer, obs_m,
                                      valid=obs_m)[1]
            return torch.autograd.grad(chi.sum(), th)[0]
    return grad


def test_mala_tracks_match_jax(monkeypatch):
    """``make_mala_sampler`` on 4 lanes, chain_len 8, tau 0.8, with the
    stand-in solve and its gradient in both packages: the rows draw for
    draw (accepts equal; thetas, misfits and L to 1e-10 relative)."""
    monkeypatch.setattr(jax_mala, "surf_forward_batch", standin_solve_jax)
    monkeypatch.setattr(jax_mala, "_grad_chi_lane", _standin_grad_jax)
    monkeypatch.setattr(dispersion, "surf_forward_batch",
                        standin_solve_torch)
    monkeypatch.setattr(mala, "_grad_chi_lane", _standin_grad_torch)
    (jcm, jargs, juse), (tcm, targs, tuse) = _lanes(4, seed=7)
    ji, jr = jax_mala.make_mala_sampler(
        jcm, JaxPoint, jax_solver_cfg(), "rayleigh",
        jax_mala.MalaConfig(tau=0.8, chain_len=8))
    carry = jax.jit(ji)(*jargs, jargs[1].theta0, juse)
    _, rows_j = jax.jit(jr)(carry, *jargs)
    ti, tr = mala.make_mala_sampler(tcm, PointCascadia, mcmc_solver_cfg(),
                                    "rayleigh",
                                    mala.MalaConfig(tau=0.8, chain_len=8))
    _, rows_t = tr(ti(*targs, targs[1].theta0, tuse), *targs)
    rows_t, rows_j = rows_t.numpy(), np.asarray(rows_j)
    assert rows_t.shape == rows_j.shape == (8, 4, 9)
    np.testing.assert_array_equal(rows_t[..., 2], rows_j[..., 2])
    np.testing.assert_allclose(rows_t[..., 3:], rows_j[..., 3:], rtol=1e-10)
    np.testing.assert_allclose(rows_t[..., 0], rows_j[..., 0], rtol=1e-10)
    # L = exp(-chi/2) underflows to subnormals here, which XLA flushes to 0
    np.testing.assert_allclose(rows_t[..., 1], rows_j[..., 1], rtol=1e-10,
                               atol=1e-300)
    assert 0 < rows_t[1:, :, 2].mean() < 1


def test_mala_mechanics(tmp_path):
    """``mala_point`` with the real solve and gradient, runN 16 / chainL
    8, tau 0.5: the reference npz format, finite rows, row 0 of each
    chain accepted, acceptance above 0.05, the misfit moves, PostPoint
    reads it."""
    path = mala.mala_point(_point(PointCascadia), outdir=str(tmp_path),
                           pid="m", runN=16, chainL=8, seed=3, tau=TAU,
                           scfg=CPU_SCFG, device="cpu")
    tr = np.load(path, allow_pickle=True)["mcTrack"]
    assert tr.shape == (16, 9)
    assert np.isfinite(tr).all()
    assert (tr[::8, 2] == 1).all()
    acc = tr[:, 2].mean()
    assert 0.05 < acc <= 1.0, f"degenerate acceptance {acc}"
    assert np.unique(np.round(tr[:, 0], 6)).size > 5
    pp = PostPoint(path, device="cpu")
    assert np.isfinite(pp.misfits).all()

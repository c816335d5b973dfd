"""Gradient-informed (MALA) sampler.

Counterpart of the JAX package's ``inversion/mala.py``.  The whole
forward — layer parameterisation, thermal models, earth flattening,
attenuation, secular function — is differentiable, so the
Metropolis-adjusted Langevin algorithm applies:

    theta' = theta + (tau^2/2) M grad(log pi)(theta) + tau sqrt(M) xi
    log pi  = -chi^2_capped / 2   (+ prior indicator)

with the exact Metropolis-Hastings correction for the asymmetric
proposal; ``M = diag(step_i^2)`` is the natural per-parameter
preconditioner, the Brownian step scales the reference's YAML carries.
The drift is capped (truncated MALA, :class:`MalaConfig`), in the
proposal and in both proposal densities alike.

Gradient path: the likelihood gradient in theta runs through the
implicit function theorem at the solved roots,

    d chi / d theta = sum_p (d chi/d c_p) * ( -F_theta,p / F_c,p ),

evaluated by autograd of the eager float64 secular function composed
with the compiled model build, all lanes at once (the roots come from
the batched solve and are held fixed — the frozen-root convention of
:func:`pysurfinv_tpu_torch.ops.kernels.sensitivity_kernels`).

Proposal semantics differ from the RWM samplers on purpose: no
retry-until-prior loop — a proposal violating the bounds or the
``isgood`` prior is REJECTED by MH (alpha = 0), which targets exactly
posterior x prior-indicator.  Rows follow the reference npz convention
(``[misfit, L, accept] + theta`` per proposal, lanes = independent
chainL-step segments), so PostPoint and Model3D read MALA chains
unchanged.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.inversion.adaptive import point_lanes
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.mcmc import (ChainConfig,
                                                make_segmented_sampler)
from pysurfinv_tpu_torch.ops.dispersion import _secular_fn
from pysurfinv_tpu_torch.ops.flatten import effective_thickness
from pysurfinv_tpu_torch.ops.kernels import _flat_model
from pysurfinv_tpu_torch.ops.secular import effective_halfspace


class MalaConfig(NamedTuple):
    tau: float = 0.8          # global step scale on the Brownian-step
    #                           preconditioner; tau=1 puts the NOISE at
    #                           the RWM step size while the drift pulls
    #                           downhill
    drift_max: float = 0.5    # truncated-MALA drift cap, in units of
    #                           the proposal noise scale (tau * step):
    #                           chi^2 gradients reach O(1e2-1e3) in step
    #                           units near the posterior, so the raw
    #                           Langevin drift overshoots, and a cap
    #                           larger than the noise kills the reverse-
    #                           density term instead; half the noise sd
    #                           bounds the asymmetry penalty at O(1)
    chain_len: int = 1000
    misfit_fail: float = 88888.0


def _grad_chi_lane(cm, pcls, scfg, wave: str):
    """The lanes' d(chi_capped)/d(theta) at frozen roots.

    Returns ``grad(thetas, psi, T, c_star, obs_c, uncer, obs_m) -> (N,
    k)``: every argument has a leading lane axis (``c_star`` (N, P) the
    solved roots, 0 where the solve failed).  Thetas go through
    ``build_profile_batch`` as an autograd leaf; each lane's flat model
    at its periods and its closure layers (from the model, detached) give
    F; one backward pass in c gives F_c at the frozen model, a second,
    weighted by ``dchi/dc / F_c``, the gradient in theta.  A lane with
    no solved period gets zero drift.
    """
    misfit_from_c = pcls._misfit_from_c
    kind = 1 if wave in ("love", "lov", "L") else 2
    F = _secular_fn(wave)

    def grad(thetas, psi, T, c_star, obs_c, uncer, obs_m):
        ok_p = c_star > 0.0
        with torch.enable_grad():
            # d chi / d c at the solved roots (soft cap included)
            c = c_star.detach().requires_grad_(True)
            chi = misfit_from_c(c, T, obs_c, uncer, obs_m, valid=obs_m)[1]
            dchi_dc, = torch.autograd.grad(chi.sum(), c)

            th = thetas.detach().requires_grad_(True)
            h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(th, psi)
            he = effective_thickness(h, nlay)
            nl = nlay[:, None]
            # (N, P, L) material at each period, (N, 1, L) thicknesses
            mdl = _flat_model(T, *(x[:, None, :] for x in (vp, vs, rho, he,
                                                            qsi)),
                              nl, kind, scfg)
            # failed roots evaluate F at a harmless c instead (zero
            # cotangent there), so no NaN reaches the gradient
            c_safe = torch.where(ok_p, c_star, vs[:, :1].detach() + 0.5)
            mm = effective_halfspace(c_safe, T, mdl[1].detach(),
                                     mdl[3].detach(), nl, scfg.fact)
            c_in = c_safe.detach().requires_grad_(True)
            Fv = F(c_in, T, mdl, mm)
            # F_c per period at the frozen model of this theta
            f_c, = torch.autograd.grad(Fv.sum(), c_in, retain_graph=True)
            f_c = torch.where(f_c.abs() > 0, f_c, torch.ones_like(f_c))
            cot = torch.where(ok_p, dchi_dc / f_c, torch.zeros_like(f_c))
            g, = torch.autograd.grad(Fv, th, grad_outputs=cot)
        return torch.where(ok_p.any(dim=-1, keepdim=True), -g,
                           torch.zeros_like(g))

    return grad


def make_mala_sampler(cm: CompiledModel, pcls, scfg, wave: str,
                      mcfg: MalaConfig):
    """(init_fn, run_fn) over batched lanes (lanes = chain segments).

    ``run_fn(carry, lane_keys, spec_b, ctx_b) -> (carry, rows)`` where
    rows is (chain_len, N, 3 + k): row 0 evaluates the start model with
    accept forced (the reference's reset-row convention), rows 1.. are
    MALA proposals.  The carry is ``(theta, misfit, chi, L, grad,
    roots)``.
    """
    from pysurfinv_tpu_torch.parallel.grid import chi_sqr_fn

    eval_batch = chi_sqr_fn(cm, pcls, wave, scfg)
    glane = _grad_chi_lane(cm, pcls, scfg, wave)

    def isgood(thetas, ctx):
        return cm.isgood(thetas, ctx[0])

    def grad_batch(thetas, ctx_b, cP):
        psi, per, obs_c, uncer, obs_m = ctx_b
        return glane(thetas, psi, per, cP.to(thetas.dtype), obs_c, uncer,
                     obs_m)

    # start thetas: the RWM init (prior-accepted uniform draws / the
    # injected initMod theta)
    rwm_init, _ = make_segmented_sampler(
        isgood, None, ChainConfig(chain_len=mcfg.chain_len))

    def init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        theta = rwm_init(lane_keys, spec_b, ctx_b, theta_init_b,
                         use_init_b)[0]
        z = torch.zeros(theta.shape[0], dtype=theta.dtype,
                        device=theta.device)
        return (theta, z, z, z, torch.zeros_like(theta),
                torch.zeros(ctx_b[1].shape, dtype=torch.float32,
                            device=theta.device))

    def run_fn(carry, lane_keys, spec_b, ctx_b):
        tau = mcfg.tau
        sd = spec_b.step            # (N, k) per-parameter scales
        M = sd * sd
        dmax = mcfg.drift_max * tau * sd

        def drift_of(ga):
            return torch.minimum(torch.maximum(-0.25 * tau * tau * M * ga,
                                               -dmax), dmax)

        def logq(b, a, ga):
            """log q(a -> b) for the capped drift at a."""
            d = b - (a + drift_of(ga))
            return -(d * d / (2.0 * tau * tau * M)).sum(dim=-1)

        # step folds start past the init folds (2*CL, 2*CL+1 of
        # make_segmented_sampler), so no step key collides with an init
        # draw for any chain_len
        fold0 = 2 * mcfg.chain_len + 2
        rows = []
        for r in range(mcfg.chain_len):
            theta0, m0, chi0, L0, g0, cw = carry
            dtype = theta0.dtype
            at_init = r == 0
            if at_init:
                prop = theta0
            else:
                xi = R.normal(R.fold_in(lane_keys, fold0 + 3 * r),
                              (theta0.shape[-1],), dtype)
                prop = theta0 + drift_of(g0) + tau * sd * xi
            in_b = ((prop >= spec_b.vmin)
                    & (prop <= spec_b.vmax)).all(dim=-1)
            okp = in_b & isgood(prop, ctx_b)

            # out-of-bounds proposals are evaluated too (they are
            # rejected below)
            m1, chi1, L1, cP1 = eval_batch(prop, ctx_b, cw)
            g1 = grad_batch(prop, ctx_b, cP1)

            log_a = (-(chi1 - chi0) / 2.0
                     + logq(theta0, prop, g1) - logq(prop, theta0, g0))
            u = R.uniform(R.fold_in(lane_keys, fold0 + 3 * r + 1), (),
                          dtype=dtype)
            accept = (torch.log(u) < log_a) & okp & (m1 < mcfg.misfit_fail)
            if at_init:
                accept = torch.ones_like(accept)

            rows.append(torch.cat([torch.stack([m1, L1, accept.to(dtype)],
                                               dim=1), prop], dim=1))
            acc = accept[:, None]
            carry = (torch.where(acc, prop, theta0),
                     torch.where(accept, m1, m0),
                     torch.where(accept, chi1, chi0),
                     torch.where(accept, L1, L0),
                     torch.where(acc, g1, g0), cP1)
        return carry, torch.stack(rows)

    return init_fn, run_fn


def mala_point(point, outdir="MCtest_mala", pid=None, runN=6000,
               chainL=200, seed=42, tau=0.8, wave="rayleigh", scfg=None,
               verbose=False, init_all=False, device="cuda"):
    """Run MALA chains for one Point; write the reference-format npz.

    Lanes = runN//chainL independent chain segments (chain 0 starts from
    ``initMod``, the rest from prior-accepted uniform draws), so the
    output is directly comparable to ``Point.MCinvMP`` / ``invert_grid``
    chains, also by the posterior comparator (``inversion.parity``).

    ``init_all``: start EVERY lane from ``initMod`` instead of uniform
    draws.  MALA's capped drift mixes slowly, so short uniform-start
    chains may not descend to the posterior within chainL; initMod
    starts isolate posterior correctness from burn-in for a parity gate.
    Returns the npz path.
    """
    from pysurfinv_tpu_torch.parallel.grid import mcmc_solver_cfg

    t0 = time.time()
    scfg = scfg or mcmc_solver_cfg()
    cm = CompiledModel(point.initMod)
    n_chains = max(runN // chainL, 1)
    spec, ctx = point_lanes(cm, point, n_chains, device)

    init_fn, run_fn = make_mala_sampler(cm, type(point), scfg, wave,
                                        MalaConfig(tau=tau, chain_len=chainL))
    lane_keys = R.fold_in(R.PRNGKey(seed, device=device),
                          torch.arange(n_chains, device=device))
    use_init = (torch.ones(n_chains, dtype=torch.bool, device=device)
                if init_all else
                torch.arange(n_chains, device=device) == 0)
    carry = init_fn(lane_keys, spec, ctx, spec.theta0, use_init)
    carry, rows = run_fn(carry, lane_keys, spec, ctx)
    rows = rows.cpu().numpy()                     # (chainL, N, 3+k)
    track = np.moveaxis(rows, 0, 1).reshape(-1, rows.shape[-1])
    pid = pid or point.pid
    point._save_npz(outdir, pid, track, chainL)
    if verbose:
        print(f"mala_point: {n_chains} x {chainL} steps in "
              f"{time.time() - t0:.1f}s, acceptance "
              f"{track[:, 2].mean():.3f}")
    return os.path.join(outdir, f"{pid}.npz")

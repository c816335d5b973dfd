"""Adaptive-covariance Metropolis (AM) and the tuned random walk.

Counterpart of the JAX package's ``inversion/adaptive.py``.  The
reference's random walk proposes every Brownian parameter independently
with a hand-tuned per-parameter step from the YAML (brownian.py:20-27);
correlated posteriors (the B-spline Vs coefficients; crustal thickness
against sediment velocity) make such axis-aligned steps mix slowly.
:func:`make_adaptive_sampler` learns a full proposal covariance
Haario-style (Adaptive Metropolis, Haario et al. 2001) and then FREEZES
it before recording, so the recorded phase is an exactly valid
symmetric-proposal Metropolis chain:

  * warmup phase 1 — diagonal proposals (the reference's own step
    scales) with Robbins-Monro adaptation of a global log-scale toward
    a target acceptance;
  * warmup phase 2 — same proposals; the lanes' states pooled into a
    Welford mean/covariance estimate (all lanes target the same
    posterior, so pooling multiplies the sample count);
  * warmup phase 3 — proposals from the Cholesky factor of
    ``cov + eps*diag(step^2)``, Robbins-Monro re-tuning of the global
    scale from the classic 2.38/sqrt(d);
  * recording — the proposal is frozen; a proposal violating the bounds
    or the ``isgood`` prior is rejected by MH (alpha = 0), which targets
    exactly posterior x prior-indicator (the convention of
    :mod:`.mala`).

:func:`tuned_rwm_point` tunes per-parameter steps on a few warm lanes
and records with them frozen.  Rows follow the reference npz convention
(``[misfit, L, accept] + theta``), so PostPoint, Model3D and the
posterior comparator read these chains unchanged.

Where the JAX code scans a step with ``lax.scan``, a Python loop runs the
steps here; the log-scales and the Welford count, mean and M2 stay device
tensors, so the adaptation itself adds no host sync to a step.  Every
draw is keyed as in the JAX package (:mod:`.random`), so with the same
likelihood the chains are the JAX sampler's draw for draw.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.mcmc import (ChainConfig,
                                                make_segmented_sampler)

# RNG fold base for this sampler's draw streams: far above the RWM init
# folds (2*chain_len, 2*chain_len + 1; mcmc.py) for any practical
# chain_len, so no key collides with an init draw.
_FOLD_BASE = 1 << 20


class AdaptConfig(NamedTuple):
    warmup1: int = 384        # diag proposals, scale adaptation
    warmup2: int = 512        # diag proposals, covariance accumulation
    warmup3: int = 384        # chol proposals, scale re-adaptation
    target_acc: float = 0.27  # RM target (d-dimensional RWM optimum
    #                           0.234, nudged up for the bounded prior)
    gamma: float = 0.08       # Robbins-Monro rate on log-scale
    eps: float = 0.05         # diagonal regularisation, in units of
    #                           diag(step^2) — keeps the proposal full
    #                           rank when warmup samples underspan
    chain_len: int = 1000
    misfit_fail: float = 88888.0


def point_lanes(cm, point, n, device):
    """``n`` lanes of one point: its BrownianSpec (float64) and the lane
    context ``(psi, periods, obs_c, uncer, obs_m)``, on ``device``."""
    from pysurfinv_tpu_torch.convert import spec_from_numpy

    rep = lambda x: np.repeat(np.asarray(x)[None], n, 0)  # noqa: E731
    spec, psi = spec_from_numpy(tuple(rep(f) for f in
                                      cm.spec_of(point.initMod)),
                                rep(cm.psi_of(point.initMod)), device=device)
    ctx = (psi, *(torch.as_tensor(rep(x), device=device)
                  for x in point._obs_arrays()))
    return spec, ctx


def make_adaptive_sampler(cm: CompiledModel, pcls, scfg, wave: str,
                          acfg: AdaptConfig):
    """(init_fn, warmup_fn, run_fn) over batched lanes.

    ``warmup_fn(carry, lane_keys, spec_b, ctx_b) -> (carry, chol, scale)``
    runs the three warmup phases and returns the frozen proposal;
    ``run_fn(carry, lane_keys, spec_b, ctx_b, chol, scale) -> (carry,
    rows)`` records ``chain_len`` rows (row 0 evaluates the start model
    with accept forced — the reference reset-row convention); ``scale``
    is a scalar or a per-lane (N, 1) tensor.  The carry is ``(theta,
    misfit, chi, L, roots)``: the roots of each lane's last evaluated
    model seed the next solve.
    """
    from pysurfinv_tpu_torch.parallel.grid import chi_sqr_fn

    eval_batch = chi_sqr_fn(cm, pcls, wave, scfg)

    def isgood(thetas, ctx):
        return cm.isgood(thetas, ctx[0])

    rwm_init, _ = make_segmented_sampler(
        isgood, None, ChainConfig(chain_len=acfg.chain_len))

    def init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        theta = rwm_init(lane_keys, spec_b, ctx_b, theta_init_b,
                         use_init_b)[0]
        m, chi, L, cP = eval_batch(theta, ctx_b,
                                   torch.zeros(ctx_b[1].shape,
                                               dtype=torch.float32,
                                               device=theta.device))
        return (theta, m, chi, L, cP)

    def _one_step(carry, lane_keys, spec_b, ctx_b, fold, draw,
                  force=False):
        """Shared MH step: ``draw(kz, theta) -> prop``; returns
        (new_carry, accept, (misfit, L, prop)).  ``force``: accept
        unconditionally (the row-0 evaluate-the-start convention; the
        proposal must equal theta0 there)."""
        theta0, m0, chi0, L0, cw = carry
        prop = draw(R.fold_in(lane_keys, fold), theta0)
        in_b = ((prop >= spec_b.vmin) & (prop <= spec_b.vmax)).all(dim=-1)
        okp = in_b & isgood(prop, ctx_b)
        # prior/bounds-rejected proposals are rejected whatever their
        # likelihood, so the forward runs at the CURRENT state there:
        # out-of-bounds parameter vectors would build unphysical models
        # that knock the solver off its warm-start window
        prop_s = torch.where(okp[:, None], prop, theta0)
        m1, chi1, L1, cP1 = eval_batch(prop_s, ctx_b, cw)
        u = R.uniform(R.fold_in(lane_keys, fold + 1), (), dtype=theta0.dtype)
        accept = (chi1 < chi0) | (u > 1.0 - torch.exp(-(chi1 - chi0) / 2.0))
        accept = accept & okp & (m1 < acfg.misfit_fail)
        if force:
            accept = torch.ones_like(accept)
        acc = accept[:, None]
        new = (torch.where(acc, prop, theta0), torch.where(accept, m1, m0),
               torch.where(accept, chi1, chi0), torch.where(accept, L1, L0),
               cP1)
        return new, accept, (m1, L1, prop)

    def rm(log_s, accept):
        """One Robbins-Monro step of a log-scale toward target_acc; the
        acceptance share and the step in float32, as the JAX package
        computes them (``jnp.mean`` of a bool array is float32)."""
        return log_s + acfg.gamma * (accept.to(torch.float32).mean()
                                     - acfg.target_acc)

    def chol_draw(chol, scale):
        def draw(kz, theta):
            z = R.normal(kz, (theta.shape[-1],), theta.dtype)
            return theta + scale * (z @ chol.T)
        return draw

    def warmup_fn(carry, lane_keys, spec_b, ctx_b):
        N, k = spec_b.theta0.shape
        dtype, dev = spec_b.theta0.dtype, spec_b.theta0.device
        sd = spec_b.step                      # (N, k) reference scales

        def diag_draw(s):
            return lambda kz, th: th + s * ((th + R.normal(kz, (k,), dtype)
                                             * sd) - th)

        # phase 1: RM scale on diagonal proposals
        log_s = torch.zeros((), dtype=dtype, device=dev)
        for r in range(acfg.warmup1):
            carry, accept, _ = _one_step(carry, lane_keys, spec_b, ctx_b,
                                         _FOLD_BASE + 2 * r,
                                         diag_draw(torch.exp(log_s)))
            log_s = rm(log_s, accept)

        # phase 2: accumulate the pooled Welford mean/cov
        f2 = _FOLD_BASE + 2 * acfg.warmup1
        cnt = torch.zeros((), dtype=dtype, device=dev)
        mean = torch.zeros((k,), dtype=dtype, device=dev)
        M2 = torch.zeros((k, k), dtype=dtype, device=dev)
        for r in range(acfg.warmup2):
            carry, accept, _ = _one_step(carry, lane_keys, spec_b, ctx_b,
                                         f2 + 2 * r,
                                         diag_draw(torch.exp(log_s)))
            log_s = rm(log_s, accept)
            th = carry[0]
            cnt = cnt + N
            delta = th - mean[None, :]
            mean = mean + delta.sum(dim=0) / cnt
            M2 = M2 + delta.T @ (th - mean[None, :])
        cov = M2 / torch.clamp(cnt - 1.0, min=1.0)
        # regularise toward the reference's diagonal scales and anchor
        # the global scale at the d-dimensional optimum 2.38/sqrt(d)
        sd0 = sd[0]
        cov = cov + acfg.eps * torch.diag(sd0 * sd0)
        chol = torch.linalg.cholesky(cov)
        s_d = 2.38 / torch.sqrt(torch.tensor(float(k), dtype=dtype,
                                             device=dev))

        # phase 3: RM re-tune of the global scale on the chol proposal
        f3 = f2 + 2 * acfg.warmup2
        log_s3 = torch.log(s_d)
        for r in range(acfg.warmup3):
            carry, accept, _ = _one_step(carry, lane_keys, spec_b, ctx_b,
                                         f3 + 2 * r,
                                         chol_draw(chol, torch.exp(log_s3)))
            log_s3 = rm(log_s3, accept)
        return carry, chol, torch.exp(log_s3)

    def run_fn(carry, lane_keys, spec_b, ctx_b, chol, scale):
        dtype = spec_b.theta0.dtype
        f4 = _FOLD_BASE + 2 * (acfg.warmup1 + acfg.warmup2 + acfg.warmup3)
        draw = chol_draw(chol, scale)
        rows = []
        for r in range(acfg.chain_len):
            at_init = r == 0
            carry, accept, (m1, L1, prop) = _one_step(
                carry, lane_keys, spec_b, ctx_b, f4 + 2 * r,
                (lambda kz, th: th) if at_init else draw, force=at_init)
            rows.append(torch.cat([torch.stack([m1, L1, accept.to(dtype)],
                                               dim=1), prop], dim=1))
        return carry, torch.stack(rows)

    return init_fn, warmup_fn, run_fn


def _true_chain(rows):
    """Thetas of the true Markov chain of (steps, N, 3 + k) rows:
    rejected rows inherit the previous state."""
    th = rows[:, :, 3:].copy()
    acc = rows[:, :, 2] > 0.5
    for r in range(1, th.shape[0]):
        stay = ~acc[r]
        th[r][stay] = th[r - 1][stay]
    return th, acc


def ladder_pick(cand, accs, target_acc):
    """The global step multiplier: the acceptance curve ``accs`` of the
    ladder ``cand`` (ascending), made non-increasing by a running minimum,
    log-interpolated at ``target_acc``; the ladder's end where the target
    lies outside it.  On a non-increasing ladder this is the JAX
    package's pick; on one that a noisy rung makes non-monotone it still
    interpolates a monotone curve and stays within the ladder."""
    accs = np.minimum.accumulate(np.asarray(accs, float))
    if accs[0] <= target_acc:
        return float(cand[0])
    if accs[-1] >= target_acc:
        return float(cand[-1])
    return float(np.exp(np.interp(-target_acc, -accs, np.log(cand))))


def tuned_rwm_point(point, outdir="MCtest_trwm", pid=None, runN=6000,
                    chainL=1000, seed=42, wave="rayleigh", scfg=None,
                    target_acc: float = 0.15, std_steps: int = 128,
                    rm_rounds: int = 4, rm_steps: int = 32,
                    gamma: float = 0.6, warm_lanes: int = 48,
                    verbose=False, device="cuda"):
    """Auto-tuned random walk: per-component step sizes adapted on warm
    lanes, then frozen for the recorded chains.

    The reference carries hand-tuned per-parameter steps in the YAML
    (brownian.py:7); on the Cascadia fixture they give ~15% acceptance
    and a min-over-components ESS limited by the worst-scaled parameter.
    Two warmup phases, each on ``warm_lanes`` parallel lanes whatever
    ``runN`` (warmup cost is sequential steps; lanes ride along):

      1. scale shape: ``std_steps`` steps of the batched RWM sampler with
         the reference steps, then ``step_i = lambda * std_i`` from the
         pooled true-chain posterior stds of the second half;
      2. global scale: one parallel ladder segment of ``2 * rm_steps``
         rows, lanes in 6 groups proposing at ``lambda_g * std`` (octaves
         around the median of step/std), through the same symmetric
         Gaussian step as the recorded phase; ``lambda`` interpolates the
         measured acceptance curve at ``target_acc``
         (:func:`ladder_pick`).

    The recorded phase then runs the symmetric plain-Gaussian proposal
    with the frozen diagonal steps and bounds/prior rejection by MH (the
    :func:`make_adaptive_sampler` step with a diagonal Cholesky factor),
    NOT the reference's truncated-normal retry-until-in-bounds kernel,
    whose missing Hastings correction for the truncation grows with the
    step size: the symmetric kernel targets posterior x prior-indicator
    exactly at any step.  Tuned steps never exceed half the parameter's
    range.  ``rm_rounds`` and ``gamma`` are accepted for call
    compatibility with an earlier sequential tuner and unused.  Writes
    ``{outdir}/{pid}.npz`` in the reference chain format and returns
    its path; the wall time includes the warmup.
    """
    from pysurfinv_tpu_torch.parallel.grid import (batched_sampler,
                                                   mcmc_solver_cfg)

    t0 = time.time()
    scfg = scfg or mcmc_solver_cfg()
    cm = CompiledModel(point.initMod)
    n_chains = max(runN // chainL, 1)
    n_warm = max(n_chains, warm_lanes)
    spec, ctx = point_lanes(cm, point, n_chains, device)
    spec_w, ctx_w = point_lanes(cm, point, n_warm, device)
    pcls = type(point)

    key0 = R.PRNGKey(seed, device=device)
    k_warm = R.fold_in(R.fold_in(key0, 777),
                       torch.arange(n_warm, device=device))
    use_init_w = torch.arange(n_warm, device=device) == 0

    # ---- phase 1: posterior stds with the reference steps ------------
    init_fn, seg_fn = batched_sampler(cm, pcls, ChainConfig(chain_len=chainL),
                                      wave, scfg)
    carry = init_fn(k_warm, spec_w, ctx_w, spec_w.theta0, use_init_w)
    carry, rows = seg_fn(carry, k_warm, spec_w, ctx_w, 0, std_steps)
    th, _ = _true_chain(rows.cpu().numpy())
    # drop the first half as burn-in, pool lanes
    samp = th[std_steps // 2:].reshape(-1, cm.ntheta)
    stds = np.maximum(samp.std(axis=0), 1e-8)
    spec1 = cm.spec_of(point.initMod)
    half = 0.5 * (spec1.vmax - spec1.vmin)

    # ---- phase 2: parallel global-scale ladder ----------------------
    # the proposal scale is per-lane data, so the whole ladder runs in
    # one segment through the recorded phase's symmetric step (the
    # reference's truncated+retry kernel reads systematically higher
    # acceptance at the same scale and would mis-calibrate the pick)
    lam0 = float(np.median(spec1.step / stds))
    cand = lam0 * np.power(2.0, np.arange(-1.0, 5.0))     # 6 octaves
    n_grp = len(cand)
    group = np.arange(n_warm) % n_grp
    _, _, probe = make_adaptive_sampler(cm, pcls, scfg, wave,
                                        AdaptConfig(chain_len=2 * rm_steps))
    dt = spec_w.theta0.dtype
    # the phase-1 carry (theta, m, chi, L, roots) is the adaptive carry
    carry, rows = probe(carry, k_warm, spec_w, ctx_w,
                        torch.diag(torch.as_tensor(stds, dtype=dt,
                                                   device=device)),
                        torch.as_tensor(cand[group], dtype=dt,
                                        device=device)[:, None])
    th_r, acc_r = _true_chain(rows.cpu().numpy()[1:])  # drop the init row
    jumps = ((np.diff(th_r, axis=0) / stds[None, None, :]) ** 2
             ).sum(axis=2)                              # (steps-1, N)
    esjd = np.array([jumps[:, group == g].mean() for g in range(n_grp)])
    accs = np.array([acc_r[:, group == g].mean() for g in range(n_grp)])
    # the pick follows the acceptance curve; ESJD is logged, not used:
    # on this multi-modal bounded posterior it rises with lambda (rare
    # huge accepted jumps dominate it) toward a ~2% acceptance
    lam = ladder_pick(cand, accs, target_acc)
    step_fin = np.minimum(lam * stds, half)
    spec_t = spec._replace(step=torch.as_tensor(
        np.repeat(step_fin[None], n_chains, 0), dtype=dt, device=device))

    # ---- phase 3: record runN rows with the frozen tuned steps -------
    init_fn, _, run_fn = make_adaptive_sampler(cm, pcls, scfg, wave,
                                               AdaptConfig(chain_len=chainL))
    lane_keys = R.fold_in(key0, torch.arange(n_chains, device=device))
    use_init = torch.arange(n_chains, device=device) == 0
    carry = init_fn(lane_keys, spec_t, ctx, spec_t.theta0, use_init)
    carry, rows = run_fn(carry, lane_keys, spec_t, ctx,
                         torch.diag(spec_t.step[0]),
                         torch.ones((), dtype=dt, device=device))
    rows = rows.cpu().numpy()
    track = np.moveaxis(rows, 0, 1).reshape(-1, rows.shape[-1])
    pid = pid or point.pid
    point._save_npz(outdir, pid, track, chainL)
    if verbose:
        lad = ", ".join(f"{c:.2f}:a{a:.2f}/j{e:.2f}"
                        for c, a, e in zip(cand, accs, esjd))
        print(f"tuned_rwm_point: {n_chains} x {chainL} "
              f"(+{std_steps + 2 * rm_steps} warmup @ {n_warm} lanes) "
              f"in {time.time() - t0:.1f}s, acceptance "
              f"{track[:, 2].mean():.3f}, lambda {lam:.3f} "
              f"[ladder {lad}]")
    return os.path.join(outdir, f"{pid}.npz")


def adaptive_point(point, outdir="MCtest_am", pid=None, runN=6000,
                   chainL=1000, seed=42, wave="rayleigh",
                   acfg: AdaptConfig | None = None, scfg=None,
                   verbose=False, init_all=False, device="cuda"):
    """Run AM chains for one Point; write the reference-format npz.

    Lanes = runN//chainL independent chain segments (chain 0 starts from
    ``initMod``, the rest from prior-accepted uniform draws, or every
    lane from ``initMod`` with ``init_all``) — the ``Point.MCinvMP``
    layout, so outputs feed PostPoint / Model3D / the parity comparator
    unchanged.  Returns the npz path.
    """
    from pysurfinv_tpu_torch.parallel.grid import mcmc_solver_cfg

    t0 = time.time()
    scfg = scfg or mcmc_solver_cfg()
    acfg = acfg or AdaptConfig(chain_len=chainL)
    if acfg.chain_len != chainL:
        acfg = acfg._replace(chain_len=chainL)
    cm = CompiledModel(point.initMod)
    n_chains = max(runN // chainL, 1)
    spec, ctx = point_lanes(cm, point, n_chains, device)

    init_fn, warmup_fn, run_fn = make_adaptive_sampler(
        cm, type(point), scfg, wave, acfg)
    lane_keys = R.fold_in(R.PRNGKey(seed, device=device),
                          torch.arange(n_chains, device=device))
    use_init = (torch.ones(n_chains, dtype=torch.bool, device=device)
                if init_all else
                torch.arange(n_chains, device=device) == 0)

    carry = init_fn(lane_keys, spec, ctx, spec.theta0, use_init)
    carry, chol, scale = warmup_fn(carry, lane_keys, spec, ctx)
    carry, rows = run_fn(carry, lane_keys, spec, ctx, chol, scale)
    rows = rows.cpu().numpy()                     # (chainL, N, 3+k)
    track = np.moveaxis(rows, 0, 1).reshape(-1, rows.shape[-1])
    pid = pid or point.pid
    point._save_npz(outdir, pid, track, chainL)
    if verbose:
        print(f"adaptive_point: {n_chains} x {chainL} steps "
              f"(+{acfg.warmup1 + acfg.warmup2 + acfg.warmup3} warmup) "
              f"in {time.time() - t0:.1f}s, acceptance "
              f"{track[:, 2].mean():.3f}, scale {float(scale):.3f}")
    return os.path.join(outdir, f"{pid}.npz")

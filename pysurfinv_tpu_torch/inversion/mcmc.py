"""Time-major batched Metropolis sampler over lanes of (point, chain).

Counterpart of the JAX package's ``inversion/mcmc.py``: the batched
sampler, and the per-chain "legacy" kernel ``make_chain_kernel`` /
``run_chains`` with the JAX package's key tree, its chains run as lanes
(see :func:`make_chain_kernel`).  Reference semantics (point.py:32-125):

  * proposal — every Brownian parameter takes a Gaussian step rejected
    until in bounds (brownian.py:20-27) == a truncated normal, drawn
    directly;
  * whole-model proposals are retried until the prior accepts them
    (models.py:192-205) — a fixed budget of retry rounds, perturbations
    first and uniform resets after; a lane that exhausts it stays put,
    counted as a rejection;
  * chain segmentation — every ``chainL`` steps the chain restarts from
    a uniform draw (point.py:47-55); segments are independent, so each
    is a lane, and all lanes advance one step per iteration of the
    time loop, with ONE batched forward solve for all of them;
  * Metropolis rule on the soft-capped chi^2 (point.py:26-37); a failed
    forward gives misfit 88888 and a rejection;
  * ``priori=True`` skips the forward entirely to sample the prior.

Every draw is a pure function of (lane key, global row) through the
counter-based streams of :mod:`.random`, with the JAX package's keying
(on the card a retry round's draws are one kernel launch,
:func:`_draw_round`):
the tracks are those of the JAX sampler (the tests check them draw for
draw), segmented runs equal monolithic ones, and a lane's track does not
depend on which other lanes share its batch.

``isgood(thetas, ctx)`` and ``chi_sqr_batch(thetas, ctx[, aux])`` take a
lane batch: (M, ntheta) thetas and a tuple of per-lane context tensors
with the same leading axis.  The recorded rows are ``[misfit, L,
accepted] + theta`` — the npz chain format PostPoint consumes
(point.py:80-85).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from pysurfinv_tpu_torch import profiling
from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.ops import draw_lanes as DL
from pysurfinv_tpu_torch.ops._cuda_build import _resolve


def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v is not None else int(default)


class ChainConfig(NamedTuple):
    chain_len: int = 1000          # steps per independent chain segment
    n_perturb_rounds: int = 100    # retry cap, prior-rejected proposals
    n_reset_rounds: int = 500      # retry cap, uniform resets
    priori: bool = False           # sample the prior only
    misfit_fail: float = 88888.0   # sentinel for failed forwards
    propose_flat: int = _env_int("PYSURFINV_PROPOSE_FLAT", 2048)
    #   ^ target flat batch per retry round: stage s of the compacted
    #   retry pyramid draws W_s = clamp(propose_flat // M_s, 1, 64)
    #   candidates per lane per round, so the compacted tail of lanes
    #   whose prior is hard to satisfy drains its retry budget in few
    #   rounds.  Results are bit-identical for any width.
    propose_ratio: int = _env_int("PYSURFINV_PROPOSE_RATIO", 2)
    #   ^ compaction-pyramid shrink factor: stage sizes N/r, N/r^2, ...
    #   Results are bit-identical for any ratio.


def truncated_step(keys, thetas, step, vmin, vmax):
    """One bounded Gaussian proposal per lane for the whole parameter
    vector: (N, 2) keys, (N, P) thetas and bounds."""
    lo = (vmin - thetas) / step
    hi = (vmax - thetas) / step
    z = R.truncated_normal(keys, lo, hi, (thetas.shape[-1],),
                           dtype=thetas.dtype)
    return thetas + z * step


def uniform_reset(keys, vmin, vmax, dtype):
    u = R.uniform(keys, (vmin.shape[-1],), dtype=dtype)
    return vmin + u * (vmax - vmin)


def _draw(n_pert, keys, thetas, spec):
    """The candidates of one leading row of ``keys`` (W, M, 2) each: a
    perturbation for the first ``n_pert`` rows, a uniform reset after
    (the same key feeds whichever applies, as in the JAX sampler's
    select), in torch ops.  Returns (W, M, P)."""
    parts = []
    if n_pert:
        parts.append(truncated_step(keys[:n_pert], thetas, spec.step,
                                    spec.vmin, spec.vmax))
    if n_pert < keys.shape[0]:
        parts.append(uniform_reset(keys[n_pert:], spec.vmin, spec.vmax,
                                   thetas.dtype))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _draw_round(r, ks, thetas, spec, W, cfg, backend="auto"):
    """The draws of retry rounds r .. r+W-1: every lane's key chain
    (M, 2) walked W splits (key 0 of a split carries on, key 1 feeds a
    draw) and a candidate from each subkey, a perturbation while the
    round is below n_perturb_rounds and a uniform reset after.  CUDA keys
    take one kernel launch (``draw_lanes.draw_round``), CPU keys the
    torch walk and :func:`_draw`.  ``backend`` forces either, for the
    tests; the plain side's candidates take their bits from
    ``random.random_bits``, which follows the keys' device.  Returns the
    walked keys and the candidates (W, M, P)."""
    n_pert = min(max(cfg.n_perturb_rounds - r, 0), W)
    if _resolve("draw_round", backend, ks):
        profiling.count("draw.kernel_rounds")
        return DL.draw_round(ks, thetas, spec.step, spec.vmin, spec.vmax,
                             W, n_pert)
    profiling.count("draw.plain_rounds")
    kj = []
    for _ in range(W):
        k2 = R.split(ks, backend="plain")
        ks = k2[:, 0]
        kj.append(k2[:, 1])
    return ks, _draw(n_pert, torch.stack(kj), thetas, spec)


def _take(x, idx):
    if isinstance(x, tuple):
        return type(x)(*(_take(e, idx) for e in x)) \
            if hasattr(x, "_fields") else tuple(_take(e, idx) for e in x)
    return x[idx]


def _tile(x, w):
    if isinstance(x, tuple):
        return type(x)(*(_tile(e, w) for e in x)) \
            if hasattr(x, "_fields") else tuple(_tile(e, w) for e in x)
    return x.repeat((w,) + (1,) * (x.dim() - 1))


def _propose(keys, thetas, spec, ctx, isgood, cfg: ChainConfig):
    """Prior-accepted proposals: perturb retries, then uniform resets
    (models.py:192-219), as one retry loop over all lanes — round i
    splits every lane's key, draws one candidate and evaluates the prior
    once; a lane keeps its first passing candidate.  The counterpart of
    ``vmap(_propose)`` in the JAX package.  Returns (cand, found)."""
    max_rounds = cfg.n_perturb_rounds + cfg.n_reset_rounds
    found = torch.zeros(thetas.shape[0], dtype=torch.bool,
                        device=thetas.device)
    cand = thetas
    k = keys
    with profiling.annotate("pysurfinv.propose"):
        for i in range(max_rounds):
            with profiling.annotate("pysurfinv.draw"):
                k, prop = _draw_round(i, k, thetas, spec, 1, cfg)
                prop = prop[0]
            with profiling.annotate("pysurfinv.prior"):
                profiling.count("propose.candidates", prop.shape[0])
                good = isgood(prop, ctx) & ~found
            cand = torch.where(good[:, None], prop, cand)
            found = found | good
            profiling.count("host_syncs")
            if bool(found.all()):
                break
    return cand, found


def _n_unfound(found):
    """The lanes still without a proposal: a host read."""
    profiling.count("host_syncs")
    return int((~found).sum())


def _propose_batched(keys, thetas, spec_b, ctx_b, isgood, cfg: ChainConfig,
                     min_stage: int = 32, skip: bool = False):
    """:func:`_propose` with tail compaction — bitwise-identical lanes.

    The plain retry loop runs until every lane has a prior-accepted
    proposal, evaluating the prior on finished lanes too.  Here,
    whenever the unfound tail fits a ``propose_ratio``-times smaller
    buffer it is compacted (stable argsort on the found flag + gather)
    and the loop continues at that size, ``W`` candidates per lane per
    round (``ChainConfig.propose_flat``).  Each lane's candidate depends
    only on its own key chain and its first-success draw index, and both
    are preserved, so the result equals the plain loop's lane for lane.
    Sole deviation (as in the JAX package): the retry cap is honoured to
    within one round's width.

    ``skip``: every lane counts as found before the first round, and the
    input thetas come back unchanged (the init row of a segment).
    """
    N, Pdim = thetas.shape
    dev = thetas.device
    max_rounds = cfg.n_perturb_rounds + cfg.n_reset_rounds
    propose_flat = _env_int("PYSURFINV_PROPOSE_FLAT", cfg.propose_flat)
    if skip:
        return thetas, torch.ones(N, dtype=torch.bool, device=dev)

    def run_stage(r, found, cand, ks, th, sp, cx, stop_at):
        """Wide retry rounds until the unfound tail <= stop_at (or the
        cap): each round walks every lane's key chain W draws and
        evaluates all W x M candidates in one prior batch; a lane keeps
        the first passing candidate in draw order."""
        M = th.shape[0]
        W = max(min(propose_flat // M, 64), 1)
        cxw = _tile(cx, W)
        while r < max_rounds and _n_unfound(found) > stop_at:
            with profiling.annotate("pysurfinv.draw"):
                ks, props = _draw_round(r, ks, th, sp, W, cfg)  # (W, M, P)
            with profiling.annotate("pysurfinv.prior"):
                profiling.count("propose.candidates", W * M)
                good = isgood(props.reshape(W * M, Pdim),
                              cxw).reshape(W, M)
            first = torch.argmax(good.to(torch.int8), dim=0)
            has = good.any(dim=0)
            pick = props[first, torch.arange(M, device=dev)]
            cand = torch.where((has & ~found)[:, None], pick, cand)
            found = found | has
            r += W
        return r, found, cand, ks

    ratio = max(_env_int("PYSURFINV_PROPOSE_RATIO", cfg.propose_ratio), 2)
    # min_stage >= 1: 0 would never end the pyramid-size loop
    min_stage = max(_env_int("PYSURFINV_PROPOSE_MINSTAGE", min_stage), 1)
    sizes = []
    m = N // ratio
    while m >= min_stage:
        sizes.append(m)
        m //= ratio

    with profiling.annotate("pysurfinv.propose"):
        found = torch.zeros(N, dtype=torch.bool, device=dev)
        r, found, cand, ks = run_stage(0, found, thetas, keys, thetas,
                                       spec_b, ctx_b,
                                       sizes[0] if sizes else 0)
        for i, M in enumerate(sizes):
            stop = sizes[i + 1] if i + 1 < len(sizes) else 0
            with profiling.annotate("pysurfinv.compact"):
                idx = torch.argsort(found.to(torch.int8), stable=True)[:M]
                part = (found[idx], cand[idx], ks[idx], thetas[idx],
                        _take(spec_b, idx), _take(ctx_b, idx))
            r, f_s, c_s, k_s = run_stage(r, *part, stop)
            with profiling.annotate("pysurfinv.compact"):
                found = found.index_put((idx,), f_s)
                cand = cand.index_put((idx,), c_s)
                ks = ks.index_put((idx,), k_s)
    return cand, found


def make_segmented_sampler(isgood, chi_sqr_batch, cfg: ChainConfig,
                           aux_init=None):
    """Init/segment pair of the batched sampler.

    Every row's draws are a pure function of (lane key, global row), so
    running the chain in one piece or in any sequence of segments gives
    the same tracks.  The chain-format init row is row 0 of the first
    segment: ``init_fn`` only builds prior-accepted start thetas, and the
    segment evaluates them at global row 0 with acceptance forced.

    ``aux_init``: optional ``(spec_b, ctx_b) -> tensor`` building each
    lane's auxiliary state.  When set, ``chi_sqr_batch`` is called as
    ``chi(thetas, ctx_b, aux)`` and returns ``(misfit, chi, L, aux')``;
    ``aux`` always carries the LAST EVALUATED value (accepted or not) —
    the warm-start contract of ``surf_forward_batch(c_warm=...)``.

    Returns ``(init_fn, segment_fn)``:
      init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b)
        -> carry = (theta, misfit, chi, L[, aux]); misfit/chi/L are
           zeros until row 0 evaluates them
      segment_fn(carry, lane_keys, spec_b, ctx_b, s0, n_steps)
        -> (carry, rows): rows (n_steps, N, 3 + ntheta) cover global rows
           s0 .. s0 + n_steps - 1
    """

    def eval_all(thetas, ctx_b, aux):
        if aux_init is None:
            return (*chi_sqr_batch(thetas, ctx_b), aux)
        return chi_sqr_batch(thetas, ctx_b, aux)

    def init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        CL = cfg.chain_len
        dtype = spec_b.theta0.dtype
        k1 = R.fold_in(lane_keys, 2 * CL)
        k2 = R.fold_in(lane_keys, 2 * CL + 1)
        th_r, _ = _propose(k1, uniform_reset(k2, spec_b.vmin, spec_b.vmax,
                                             dtype),
                           spec_b, ctx_b, isgood,
                           cfg._replace(n_perturb_rounds=1))
        theta = torch.where(use_init_b[:, None], theta_init_b, th_r)
        z = torch.zeros(theta.shape[0], dtype=dtype, device=theta.device)
        if aux_init is None:
            return (theta, z, z, z)
        return (theta, z, z, z, aux_init(spec_b, ctx_b))

    def segment_fn(carry, lane_keys, spec_b, ctx_b, s0, n_steps):
        with profiling.annotate("pysurfinv.segment"):
            return run_segment(carry, lane_keys, spec_b, ctx_b, s0, n_steps)

    def run_segment(carry, lane_keys, spec_b, ctx_b, s0, n_steps):
        N = spec_b.theta0.shape[0]
        dtype = spec_b.theta0.dtype
        dev = spec_b.theta0.device
        col = lambda v: torch.full((N, 1), v, dtype=dtype,  # noqa: E731
                                   device=dev)
        rows = []
        for r in range(int(s0), int(s0) + n_steps):
            theta0, m0, chi0, L0, *aux = carry
            at_init = r == 0  # row 0 = evaluate-the-start-model row
            theta1, okp = _propose_batched(
                R.fold_in(lane_keys, 2 * r), theta0, spec_b, ctx_b, isgood,
                cfg, skip=at_init)
            if cfg.priori:
                rows.append(torch.cat([col(0.0), col(1.0 if at_init else 0.0),
                                       col(1.0), theta1], dim=1))
                carry = (theta1, m0, chi0, L0, *aux)
                continue
            with profiling.annotate("pysurfinv.likelihood"):
                m1, chi1, L1, aux1 = eval_all(theta1, ctx_b,
                                              aux[0] if aux else None)
            u = R.uniform(R.fold_in(lane_keys, 2 * r + 1), (), dtype=dtype)
            accept = (chi1 < chi0) | (u > 1.0 - torch.exp(-(chi1 - chi0) / 2))
            accept = accept & okp & (m1 < cfg.misfit_fail)
            if at_init:
                accept = torch.ones_like(accept)
            rows.append(torch.cat([torch.stack([m1, L1, accept.to(dtype)],
                                               dim=1), theta1], dim=1))
            carry = (torch.where(accept[:, None], theta1, theta0),
                     torch.where(accept, m1, m0),
                     torch.where(accept, chi1, chi0),
                     torch.where(accept, L1, L0),
                     *((aux1,) if aux else ()))
        return carry, torch.stack(rows)

    return init_fn, segment_fn


def make_batched_sampler(isgood, chi_sqr_batch, cfg: ChainConfig):
    """Time-major sampler: one batched forward per MCMC step.

    Returns ``run(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b) ->
    track`` of shape (N, chain_len, 3 + ntheta); every argument has a
    leading lane axis N.  Derive ``lane_keys`` from GLOBAL lane indices
    (``fold_in(PRNGKey(seed), lane_id)``): every lane's stream is then a
    pure function of its key, however the lanes are batched.
    """
    init_fn, segment_fn = make_segmented_sampler(isgood, chi_sqr_batch, cfg)

    def run(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        carry = init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b)
        _, rows = segment_fn(carry, lane_keys, spec_b, ctx_b, 0,
                             cfg.chain_len)
        return rows.transpose(0, 1)

    return run


def make_chain_kernel(isgood, chi_sqr, cfg: ChainConfig):
    """The per-chain ("legacy") sampler, its chains run as lanes.

    Counterpart of the JAX package's ``make_chain_kernel``, which runs
    one chain as a ``lax.scan`` (vmapped over chains) with the JAX key
    tree: ``(k0, ks) = split(key)``, the start model from ``k0`` (``(k1,
    k2) = split(k0)``: a uniform draw from ``k2`` made prior-accepted by
    :func:`_propose` on ``k1`` with one perturbation round), and step
    ``i`` from ``split(ks, chain_len - 1)[i]`` as ``(k_prop, k_acc)``.
    Here every chain is a lane of one loop: the proposals of all lanes
    run in :func:`_propose` (each lane keeps its own key chain, so its
    draws are those of the JAX ``while_loop``), and ``chi_sqr`` gets the
    batch of proposals.

    Args:
      isgood:  (thetas (N, P), ctx) -> (N,) bool.
      chi_sqr: (thetas (N, P), ctx) -> (misfit, chiSqr, L), each (N,);
               never called in priori mode.
      cfg:     ChainConfig.

    Returns ``run(keys, spec_b, ctx_b, theta_init_b, use_init_b) ->
    track`` of shape (N, chain_len, 3 + P): columns [misfit, L,
    accepted, theta]; every argument has a leading lane axis N.
    """

    def eval_misfit(thetas, ctx):
        if cfg.priori:
            z = torch.zeros(thetas.shape[0], dtype=thetas.dtype,
                            device=thetas.device)
            return z, z, torch.ones_like(z)
        return chi_sqr(thetas, ctx)

    def run(keys, spec_b, ctx_b, theta_init_b, use_init_b):
        dtype = spec_b.theta0.dtype
        k0ks = R.split(keys)
        k0, ks = k0ks[:, 0], k0ks[:, 1]
        k12 = R.split(k0)
        th_r, _ = _propose(k12[:, 0],
                           uniform_reset(k12[:, 1], spec_b.vmin, spec_b.vmax,
                                         dtype),
                           spec_b, ctx_b, isgood,
                           cfg._replace(n_perturb_rounds=1))
        theta = torch.where(use_init_b[:, None], theta_init_b, th_r)
        misfit, chi, L = eval_misfit(theta, ctx_b)
        one = torch.ones_like(misfit)
        rows = [torch.cat([torch.stack([misfit, L, one], dim=1), theta],
                          dim=1)]
        step_keys = R.split(ks, cfg.chain_len - 1)
        for i in range(cfg.chain_len - 1):
            kpa = R.split(step_keys[:, i])
            theta1, ok = _propose(kpa[:, 0], theta, spec_b, ctx_b, isgood,
                                  cfg)
            if cfg.priori:
                z = torch.zeros_like(misfit)
                rows.append(torch.cat([torch.stack([z, z, one], dim=1),
                                       theta1], dim=1))
                theta = theta1
                continue
            m1, chi1, L1 = eval_misfit(theta1, ctx_b)
            u = R.uniform(kpa[:, 1], (), dtype=dtype)
            accept = (chi1 < chi) | (u > 1.0 - torch.exp(-(chi1 - chi) / 2.0))
            accept = accept & ok & (m1 < cfg.misfit_fail)
            rows.append(torch.cat([torch.stack([m1, L1, accept.to(dtype)],
                                               dim=1), theta1], dim=1))
            theta = torch.where(accept[:, None], theta1, theta)
            misfit = torch.where(accept, m1, misfit)
            chi = torch.where(accept, chi1, chi)
            L = torch.where(accept, L1, L)
        return torch.stack(rows, dim=1)

    return run


def run_chains(kernel, key, spec, ctx, n_chains: int):
    """One point's chains through the legacy kernel: chain 0 starts from
    theta0, the others from uniform draws (the MCinvMP layout,
    point.py:101-102), with the keys ``split(key, n_chains)``.

    ``key`` is one (2,) key; ``spec`` the point's BrownianSpec of (P,)
    tensors; ``ctx`` a tuple of the point's context tensors, each
    repeated to the chains here.  Returns (n_chains, chain_len, 3 + P).
    """
    keys = R.split(key, n_chains)
    use_init = torch.arange(n_chains, device=key.device) == 0
    lanes = lambda x: x.unsqueeze(0).repeat(  # noqa: E731
        (n_chains,) + (1,) * x.dim())
    spec_b = type(spec)(*(lanes(f) for f in spec))
    ctx_b = tuple(lanes(x) for x in ctx)
    return kernel(keys, spec_b, ctx_b, spec_b.theta0, use_init)

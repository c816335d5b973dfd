"""Batched surface-wave dispersion curves on a (K, B) lane grid.

Counterpart of ``surf_forward_batch`` in the JAX package's
``ops/dispersion.py`` (its fast path ``_surf_forward_batch_fast``),
which replaces the reference's sequential bracket + Neville refinement
(``calcul.f:104-223``, ``surfa.f:2-83``) with three phases:

  1. **Bracket:** per period, evaluate the secular function on a c-grid
     for all models at once and take the first sign change — the
     fundamental (lowest) root.  The cold first period narrows its hit
     cell to ``dc``; warm periods hand the ``coarse*dc`` cell straight to
     the refinement.  Each period starts just below the previous
     period's bracket; each overtone just above the previous mode's
     root.  A caller that knows the previous roots (``c_warm``, an MCMC
     sampler) replaces the whole period chain by one fused sweep.
  2. **Refine:** Illinois (regula falsi) over all (period, mode, model)
     lanes at once, with the halfspace truncation frozen at each
     bracket's upper end (the NEVILL convention, calcul.f:156-172) — or
     ``newton_sep`` separated safeguarded-Newton steps, or (``nnewton``,
     ``fuse_illinois``) the whole refinement in one ``refine_lanes``
     launch.
  3. **Group velocity:** u = c / (1 - (T/c) F_T/F_c) from forward-mode
     tangents of the secular function at the root, with the attenuated
     + flattened model held fixed (the reference's variational
     convention, surfa.f LEIGEN/REIGEN); the same tangents give a free
     Newton polish of the root.

Every secular evaluation is one call of a kernel of
:mod:`pysurfinv_tpu_torch.ops.secular_lanes`.  ``lax.cond`` of the JAX
code becomes a Python ``if`` on a reduction over the lanes: each costs
one device-to-host sync (the rescue pass, the ``c_warm`` cold fill).

:func:`surf_forward_joint` solves both waves of a batch, seeding the
Rayleigh solve from the Love roots.  The single-model :func:`surf_forward`
(with overtones) and :func:`surf_ellipticity` / :func:`surf_amplitude`
run the same three phases on the eager oracle of
:mod:`pysurfinv_tpu_torch.ops.secular`, in the caller's dtype and on the
caller's device, with no kernel — as the JAX package's single-model
``surf_forward`` always runs its XLA path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from pysurfinv_tpu_torch import profiling
from pysurfinv_tpu_torch.ops.flatten import H_MIN, model_preamble
from pysurfinv_tpu_torch.ops.secular import (
    attenuation_rescale, effective_halfspace, love_secular, rayleigh_amplitude,
    rayleigh_ellipticity, rayleigh_secular)
from pysurfinv_tpu_torch.ops.secular_assoc import (love_secular_assoc,
                                                   rayleigh_secular_assoc)
from pysurfinv_tpu_torch.ops.secular_lanes import (
    RAYLEIGH_NAMES, refine_lanes, secular_lanes, secular_lanes_frozen,
    secular_lanes_grad)


@dataclass(frozen=True)
class SurfConfig:
    """Static solver configuration (defaults mirror fast_surf/init.f:25).

    Same fields and defaults as the JAX package's ``SurfConfig``
    (``pysurfinv_tpu/ops/dispersion.py:58-184``, which documents each
    knob's measured trade-offs); ``backend`` takes the port's values.
    """

    dc: float = 0.01          # bracket step (final bracket is one dc cell)
    nscan_first: int = 512    # c-grid coverage (in dc), first period
    nscan: int = 64           # c-grid coverage (in dc), warm-started periods
    nbisect: int = 12         # Illinois refinement iterations
    nnewton: int = 0          # >0 = fused refine_lanes kernel
    coarse: int = 2           # warm-period sweep step, in dc
    coarse_first: int = 4     # cold-period (first-period) sweep step, in dc
    warm_backoff: int = 10    # warm start = previous bracket lo minus this
    #                           many dc (guards mildly non-monotonic c(T))
    fact: float = 4.0         # halfspace truncation, wavelengths
    t_base: float = 1.0       # physical-dispersion reference period
    atten: bool = True        # KEY_ATTEN (init.f:43)
    flat: bool = True         # KEY_FLAT  (init.f:45)
    nmodes: int = 1           # fundamental only by default
    compute_group: bool = True  # group velocity via implicit diff
    backend: str = "auto"     # "auto": CUDA kernels for CUDA tensors,
    #                           plain versions for CPU tensors;
    #                           "plain": plain versions on any device;
    #                           "kernel": CUDA kernels, raise on CPU;
    #                           "xla_assoc": the single-model solve on
    #                           the tree-product secular functions
    #                           (ops/secular_assoc.py, an eager
    #                           cross-check), the batched solve on the
    #                           plain versions
    fuse_illinois: bool = False  # one refine_lanes launch
    fhandoff: bool = False    # seed the refinement with the bracket
    #                           sweep's endpoint secular values
    wseed_nscan: int = 0      # fused c_warm sweep span (in dc); 0 = nscan
    wseed_backoff: int = -1   # fused c_warm sweep backoff; -1 = warm_backoff
    wseed_coarse: int = 0     # fused c_warm sweep step (in dc); 0 = coarse
    newton_sep: int = 0       # >0: this many separated safeguarded-Newton
    #                           gradient launches replace the Illinois
    #                           refinement (the MCMC sampler's setting)


def _sign(x):
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _illinois(F_eval, lo, hi, n_iter: int, f_lo=None, f_hi=None):
    """Fixed-iteration Illinois (regula falsi) on elementwise brackets.

    ``F_eval`` maps a c tensor (same shape as ``lo``) to secular values;
    every state update is an elementwise select, so any number of lanes
    run in lockstep.  ``f_lo``/``f_hi``: optional pre-computed endpoint
    values (the bracket sweep's), saving the two init evaluations.
    """
    flo = F_eval(lo) if f_lo is None else f_lo
    fhi = F_eval(hi) if f_hi is None else f_hi
    side = torch.zeros(lo.shape, dtype=torch.int32, device=lo.device)
    for _ in range(n_iter):
        denom = fhi - flo
        denom = torch.where(denom.abs() > 0, denom, torch.ones_like(denom))
        x = (lo * fhi - hi * flo) / denom
        bad = ~((x > lo) & (x < hi))
        x = torch.where(bad, 0.5 * (lo + hi), x)
        fx = F_eval(x)
        same_lo = _sign(fx) == _sign(flo)
        nlo = torch.where(same_lo, x, lo)
        nflo = torch.where(same_lo, fx, flo)
        nhi = torch.where(same_lo, hi, x)
        nfhi = torch.where(same_lo, fhi, fx)
        # Illinois halving of the stale end when the same end repeats
        nfhi = torch.where(same_lo & (side == -1), 0.5 * nfhi, nfhi)
        nflo = torch.where(~same_lo & (side == 1), 0.5 * nflo, nflo)
        side = torch.where(same_lo, -1, 1).to(torch.int32)
        lo, hi, flo, fhi = nlo, nhi, nflo, nfhi
    denom = fhi - flo
    denom = torch.where(denom.abs() > 0, denom, torch.ones_like(denom))
    root = (lo * fhi - hi * flo) / denom
    return torch.minimum(torch.maximum(root, lo), hi)


def _first_active(h, nlay):
    """Indices of the first/second non-thin layers (halfspace counts),
    per model of a (B, L) batch."""
    idx = torch.arange(h.shape[-1], device=h.device)
    nl = nlay[:, None]
    act = ((idx < nl - 1) & (h > H_MIN)) | (idx == nl - 1)
    first = torch.argmax(act.to(torch.int8), dim=-1)
    second = torch.argmax((act & (idx > first[:, None])).to(torch.int8),
                          dim=-1)
    return first, second


def _initial_c(h, vs, qsinv, nlay, t1, wave, cfg: SurfConfig):
    """Starting phase velocity for the first period (fast_surf.f:156-171),
    per model: 0.5 km/s under a water top, else the top layer's shear
    velocity (0.9x for Rayleigh) at the period's attenuation."""
    first, second = _first_active(h, nlay)
    at = lambda x, i: x.gather(-1, i[:, None])[:, 0]  # noqa: E731
    water_top = at(vs, first) < 0.1
    ilay = torch.where(water_top, second, first)
    qq = at(vs, ilay)
    if wave in RAYLEIGH_NAMES:
        qq = 0.9 * qq
    b_corr = (at(qsinv, ilay) * torch.log(cfg.t_base / t1) / math.pi
              if cfg.atten else 0.0)
    c1 = qq * (1.0 + b_corr)
    return torch.where(water_top, torch.full_like(c1, 0.5), c1)


def _all(ok):
    """``bool(ok.all())``: a host read of a device value."""
    profiling.count("host_syncs")
    return bool(ok.all())


def _mode_chain(ok, dim):
    """Mode ordering along ``dim``: mode m is only valid if modes < m
    were found."""
    prev = torch.cumprod(ok.narrow(dim, 0, ok.shape[dim] - 1).to(torch.int32),
                         dim=dim).bool()
    first = torch.ones_like(ok.narrow(dim, 0, 1))
    return ok & torch.cat([first, prev], dim=dim)


def surf_forward_batch(h, vp, vs, rho, qsinv, periods, nlay,
                       wave: str = "rayleigh", cfg: SurfConfig = SurfConfig(),
                       c_warm=None):
    """Batched dispersion solve over a leading model axis.

    Args:
      h, vp, vs, rho, qsinv: (B, L) padded models; layer ``nlay-1`` is the
        halfspace, pads replicate it with h = 0.  ``qsinv`` is 1/Qs.
      periods: (P,) periods shared by the batch, or (B, P) per model.
      nlay:    (B,) integer real-layer counts including the halfspace.
      wave:    'rayleigh' or 'love'.
      cfg:     :class:`SurfConfig`.
      c_warm:  optional (B, P) previous phase velocities (0 = unknown);
        fundamental mode only.  One fused sweep seeded at
        ``c_warm - warm_backoff*dc`` replaces the period chain; lanes
        whose window misses fall back to the cold chain.

    The device and dtype are the inputs'; the CUDA kernels take float32.

    Returns (c, u, ok), each (B, P, nmodes); c and u are 0 where ok is
    False.
    """
    with profiling.annotate("pysurfinv.solve"):
        return _solve_batch(h, vp, vs, rho, qsinv, periods, nlay, wave, cfg,
                            c_warm)


def _solve_batch(h, vp, vs, rho, qsinv, periods, nlay, wave, cfg, c_warm):
    """The body of :func:`surf_forward_batch`."""
    # "xla_assoc" names the JAX package's non-Pallas path: the plain
    # versions here
    backend = "plain" if cfg.backend == "xla_assoc" else cfg.backend
    B = h.shape[0]
    dtype, device = h.dtype, h.device
    nlay = torch.as_tensor(nlay, device=device).to(torch.int32)
    kind = 1 if wave in ("love", "lov", "L") else 2
    h_eff, fac = model_preamble(h, nlay, kind, cfg.flat)
    model_T = tuple(x.T.contiguous() for x in (
        vp, vs, rho, qsinv, fac.h_flat, fac.vel_fac, fac.rho_fac))

    def Fv(c, t, mmf):
        return secular_lanes(c, t, mmf, *model_T, nlay, wave=wave,
                             fact=cfg.fact, t_base=cfg.t_base,
                             atten=cfg.atten, backend=backend)

    def Ff(c, t, mmf):
        return secular_lanes_frozen(c, t, mmf, *model_T, nlay, wave=wave,
                                    t_base=cfg.t_base, atten=cfg.atten,
                                    backend=backend)

    def Fg(c, t, mmf):
        return secular_lanes_grad(c, t, mmf, *model_T, nlay, wave=wave,
                                  t_base=cfg.t_base, atten=cfg.atten,
                                  backend=backend)

    dc = cfg.dc
    zero_mm = lambda shp: torch.zeros(shp, dtype=torch.int32,  # noqa: E731
                                      device=device)
    first_at = lambda a, i: a.gather(0, i[None])[0]  # noqa: E731

    def sweep(c_start, t_b, K, step):
        """First ``step``-cell sign change above c_start, all models.

        The search window stops at c >= b_halfspace + 0.3
        (calcul.f:165-167) and brackets whose root would exceed the
        halfspace shear velocity are rejected (calcul.f:191).  Returns
        (c_lo, found, mm_at_upper_end, F(c_lo), F(c_lo + step)).
        """
        ladder = torch.arange(K + 1, dtype=dtype, device=device)[:, None]
        cs = c_start[None, :] + step * ladder
        tt = t_b[None, :].expand(cs.shape).contiguous()
        F, bhs, mm = Fv(cs, tt, zero_mm(cs.shape))
        sgn = _sign(F)
        within = cs < (bhs + 0.3)
        cand = (sgn[:-1] != sgn[1:]) & within[1:]
        found = cand.any(0)
        i = torch.argmax(cand.to(torch.int8), dim=0)
        c_lo = first_at(cs, i)
        found = found & (c_lo <= first_at(bhs, i + 1))
        return (c_lo, found, first_at(mm, i + 1), first_at(F, i),
                first_at(F, i + 1))

    def illinois_lanes(t_kb, lo, hi, mm_kb, n_iter, f_lo=None, f_hi=None):
        """:func:`_illinois` on (K, B) lanes at frozen truncation."""
        return _illinois(lambda cc: Ff(cc, t_kb, mm_kb), lo, hi, n_iter,
                         f_lo=f_lo, f_hi=f_hi)

    nmodes = cfg.nmodes
    periods = torch.as_tensor(periods, device=device)
    periods2 = (periods[None].expand(B, periods.shape[0])
                if periods.dim() == 1 else periods).to(dtype).contiguous()
    P = periods2.shape[1]

    def bracket_period(t, starts, nscan, coarse0, narrow):
        """(nmodes, B) brackets at one period.

        ``narrow``: re-scan the coarse hit cell down to dc (the cold
        first period).  Warm periods keep the ``coarse0 * dc`` cell and
        let the refinement absorb it.  :func:`_bracket_widths` mirrors
        the widths chosen here.
        """
        c_los, mms, founds, flos, fhis = [], [], [], [], []
        root_est = None
        for iq in range(nmodes):
            start = starts[iq]
            if iq > 0:
                # overtones start 0.1 dc above the previous mode's
                # 12-iteration root estimate (the duplicate-mode guard)
                start = torch.maximum(start, root_est + 0.1 * dc)
            if iq == 0 and coarse0 > 1:
                k = max(nscan // coarse0, 1)
                c_lo, found, mm, flo, fhi = sweep(start, t, k, coarse0 * dc)
                if narrow:
                    c_lo, found_f, mm, flo, fhi = sweep(c_lo, t, coarse0, dc)
                    found = found & found_f
                width = dc if narrow else coarse0 * dc
            else:
                c_lo, found, mm, flo, fhi = sweep(start, t, nscan, dc)
                width = dc
            if iq < nmodes - 1:
                root_est = illinois_lanes(
                    t[None], c_lo[None], c_lo[None] + width, mm[None],
                    12, f_lo=flo[None], f_hi=fhi[None])[0]
            c_los.append(c_lo)
            mms.append(mm)
            founds.append(found)
            flos.append(flo)
            fhis.append(fhi)
        return (torch.stack(c_los), torch.stack(mms), torch.stack(founds),
                torch.stack(flos), torch.stack(fhis))

    def _bracket_widths(coarse0, narrow):
        """Static per-mode bracket widths matching bracket_period."""
        w0 = dc if (narrow or coarse0 <= 1) else coarse0 * dc
        return [w0] + [dc] * (nmodes - 1)

    def chain(ok, dim):
        return _mode_chain(ok, dim) if nmodes > 1 else ok

    def cold_starts(t_b):
        c_init = _initial_c(h_eff, vs, qsinv, nlay, t_b, wave, cfg)
        return c_init[None].expand(nmodes, B).to(dtype)

    def cold_bracket():
        """Cold first-period scan + warm-started period chain + rescue.
        Returns (c_lo, mm, ok, f_lo, f_hi), each (P, nmodes, B)."""
        starts0 = cold_starts(periods2[:, 0])
        lo0, mm0, ok0, fl0, fh0 = bracket_period(
            periods2[:, 0], starts0, cfg.nscan_first, cfg.coarse_first,
            narrow=True)
        ok0 = chain(ok0, 0)
        outs = [(lo0, mm0, ok0, fl0, fh0)]
        c_start = torch.where(ok0, lo0 - cfg.warm_backoff * dc, starts0)
        alive = ok0
        for p in range(1, P):
            lok, mmk, okk, flk, fhk = bracket_period(
                periods2[:, p], c_start, cfg.nscan, cfg.coarse, narrow=False)
            okk = chain(okk & alive, 0)
            c_start = torch.where(okk, lok - cfg.warm_backoff * dc, c_start)
            alive = okk
            outs.append((lok, mmk, okk, flk, fhk))
        c_lo, mm, ok, f_lo, f_hi = (torch.stack(x) for x in zip(*outs))
        if P == 1 or _all(ok):
            return c_lo, mm, ok, f_lo, f_hi

        # ---- rescue pass: sparse period lists can outrun the warm-start
        # window; re-bracket every later period from a cold start (with
        # narrow=False so bracket widths keep the warm convention) and
        # take the cold result where the warm chain failed.
        profiling.count("solve.rescues")
        with profiling.annotate("pysurfinv.solve.rescue"):
            cold = [bracket_period(periods2[:, p],
                                   cold_starts(periods2[:, p]),
                                   cfg.nscan_first, cfg.coarse, narrow=False)
                    for p in range(1, P)]
            lo_c, mm_c, ok_c, fl_c, fh_c = (torch.stack(x)
                                            for x in zip(*cold))
            ok_c = chain(ok_c, 1)
            use = ~ok[1:] & ok_c
            ok_new = torch.cat([ok[:1], chain(ok[1:] | ok_c, 1)], 0)
            mix = lambda a, b: torch.cat(  # noqa: E731
                [a[:1], torch.where(use, b, a[1:])], 0)
            return (mix(c_lo, lo_c), mix(mm, mm_c), ok_new,
                    mix(f_lo, fl_c), mix(f_hi, fh_c))

    def warm_bracket(c_warm):
        """Fused warm bracket: ONE sweep for all (period, model) lanes,
        seeded from the caller's previous roots; lanes whose window
        misses fall back to the cold chain.  Returns cold_bracket's
        tuple and the lanes the warm window found, (P, 1, B)."""
        c_warm = torch.as_tensor(c_warm, device=device)
        w_nscan = cfg.wseed_nscan if cfg.wseed_nscan > 0 else cfg.nscan
        w_back = (cfg.wseed_backoff if cfg.wseed_backoff >= 0
                  else cfg.warm_backoff)
        w_coarse = cfg.wseed_coarse if cfg.wseed_coarse > 0 else cfg.coarse
        nprobe = max(w_nscan // w_coarse, 1)
        step_w = w_coarse * dc
        starts_w = (c_warm.T - w_back * dc).to(dtype)            # (P, B)
        ladder = step_w * torch.arange(nprobe + 1, dtype=dtype,
                                       device=device)
        cs = (starts_w[:, None, :] + ladder[None, :, None]).reshape(-1, B)
        tt = periods2.T[:, None, :].expand(P, nprobe + 1, B).reshape(-1, B)
        F, bhs, mm_all = Fv(cs.contiguous(), tt.contiguous(),
                            zero_mm(cs.shape))
        sgn = _sign(F).reshape(P, nprobe + 1, B)
        csr = cs.reshape(P, nprobe + 1, B)
        bhs_r = bhs.reshape(P, nprobe + 1, B)
        mm_r = mm_all.reshape(P, nprobe + 1, B)
        cand = (sgn[:, :-1] != sgn[:, 1:]) & (csr[:, 1:] < bhs_r[:, 1:] + 0.3)
        w_found = cand.any(1)                                  # (P, B)
        i = torch.argmax(cand.to(torch.int8), dim=1)
        tk0 = lambda a: a.gather(1, i[:, None])[:, 0]  # noqa: E731
        tk1 = lambda a: a.gather(1, (i + 1)[:, None])[:, 0]  # noqa: E731
        w_lo = tk0(csr)
        w_found = w_found & (w_lo <= tk1(bhs_r)) & (c_warm.T > 0.05)
        Fr = F.reshape(P, nprobe + 1, B)
        # the nmodes = 1 axis matches cold_bracket's layout
        c_lo, mm, ok, f_lo, f_hi = (x[:, None] for x in (
            w_lo, tk1(mm_r), w_found, tk0(Fr), tk1(Fr)))
        from_warm = ok
        if not _all(ok):
            profiling.count("solve.warm_fallbacks")
            cc_lo, cmm, cok, cf_lo, cf_hi = cold_bracket()
            c_lo = torch.where(from_warm, c_lo, cc_lo)
            mm = torch.where(from_warm, mm, cmm)
            ok = from_warm | cok
            f_lo = torch.where(from_warm, f_lo, cf_lo)
            f_hi = torch.where(from_warm, f_hi, cf_hi)
        return (c_lo, mm, ok, f_lo, f_hi), from_warm

    from_warm = None
    with profiling.annotate("pysurfinv.solve.bracket"):
        if c_warm is not None and nmodes == 1:
            (c_lo, mm, ok, f_lo, f_hi), from_warm = warm_bracket(c_warm)
        else:
            c_lo, mm, ok, f_lo, f_hi = cold_bracket()

    # ---- phase 2: refine (P*nmodes, B) lanes ----------------------------
    KL = P * nmodes
    t_l = periods2.T.repeat_interleave(nmodes, dim=0).contiguous()
    lo_l = c_lo.reshape(KL, B)
    mm_l = mm.reshape(KL, B).contiguous()
    ok_l = ok.reshape(KL, B)
    if cfg.fhandoff:
        flo_l, fhi_l = f_lo.reshape(KL, B), f_hi.reshape(KL, B)
    else:
        flo_l = fhi_l = None

    # static per-(period, mode) bracket widths -> (KL, 1); warm-seeded
    # lanes always carry a coarse*dc bracket instead
    w_pm = ([_bracket_widths(cfg.coarse_first, True)]
            + [_bracket_widths(cfg.coarse, False)] * (P - 1))
    w_l = torch.tensor([w for per in w_pm for w in per], dtype=dtype,
                       device=device).reshape(KL, 1)
    if from_warm is not None:
        wc = cfg.wseed_coarse if cfg.wseed_coarse > 0 else cfg.coarse
        w_l = torch.where(from_warm.reshape(KL, B),
                          torch.tensor(wc * dc, dtype=dtype, device=device),
                          w_l)
    hi_l = (lo_l + w_l).expand(lo_l.shape)

    def refine(n_newton, compute_group):
        return refine_lanes(lo_l.contiguous(), hi_l.contiguous(), t_l, mm_l,
                            *model_T, nlay, wave=wave, t_base=cfg.t_base,
                            atten=cfg.atten, n_ill=cfg.nbisect,
                            n_newton=n_newton, compute_group=compute_group,
                            backend=backend)

    if cfg.newton_sep >= 1:
        # separated safeguarded Newton from the bracket midpoint: each
        # step clamped to the live bracket (midpoint fallback), the last
        # a clipped Newton polish
        with profiling.annotate("pysurfinv.solve.refine"):
            s_lo = _sign(flo_l if flo_l is not None
                         else Ff(lo_l.contiguous(), t_l, mm_l))
            cur_lo, cur_hi = lo_l, hi_l
            x = 0.5 * (lo_l + hi_l)
            for j in range(cfg.newton_sep):
                f_j, fc_j, _ = Fg(x.contiguous(), t_l, mm_l)
                same_lo = _sign(f_j) == s_lo
                cur_lo = torch.where(same_lo, x, cur_lo)
                cur_hi = torch.where(same_lo, cur_hi, x)
                fc_safe = torch.where(fc_j.abs() > 0, fc_j,
                                      torch.ones_like(fc_j))
                xn = x - f_j / fc_safe
                if j == cfg.newton_sep - 1:
                    x = torch.minimum(torch.maximum(xn, cur_lo), cur_hi)
                else:
                    bad = ~((xn > cur_lo) & (xn < cur_hi))
                    x = torch.where(bad, 0.5 * (cur_lo + cur_hi), xn)
            root_l = x
        if cfg.compute_group:
            # group velocity from tangents AT the refined root, plus the
            # free clipped Newton polish from the same launch
            with profiling.annotate("pysurfinv.solve.group"):
                f_g, fc_g, ft_g = Fg(root_l.contiguous(), t_l, mm_l)
                fc_safe = torch.where(fc_g.abs() > 0, fc_g,
                                      torch.ones_like(fc_g))
                u_l = root_l / (1.0 - (t_l / root_l) * ft_g / fc_safe)
                root_l = torch.minimum(torch.maximum(root_l - f_g / fc_safe,
                                                     cur_lo), cur_hi)
        else:
            u_l = torch.zeros_like(root_l)
    elif cfg.nnewton >= 1:
        # fused refine: all Illinois iterations + Newton tail + group
        # tangents in ONE kernel launch
        with profiling.annotate("pysurfinv.solve.refine"):
            root_l, u_l = refine(cfg.nnewton, cfg.compute_group)
    else:
        with profiling.annotate("pysurfinv.solve.refine"):
            if cfg.fuse_illinois:
                # all Illinois iterations in ONE launch (same algorithm as
                # illinois_lanes, without the endpoint handoff)
                root_l, _ = refine(0, False)
            else:
                root_l = illinois_lanes(t_l, lo_l.contiguous(),
                                        hi_l.contiguous(), mm_l, cfg.nbisect,
                                        f_lo=flo_l, f_hi=fhi_l)
        if cfg.compute_group:
            # u = c / (1 - (T/c) F_T/F_c) from the kernel's forward-mode
            # tangents; the same launch's (F, F_c) give one clamped
            # Newton polish of the Illinois root for free
            with profiling.annotate("pysurfinv.solve.group"):
                f0_l, fc_l, ft_l = Fg(root_l.contiguous(), t_l, mm_l)
                fc_l = torch.where(fc_l.abs() > 0, fc_l,
                                   torch.ones_like(fc_l))
                u_l = root_l / (1.0 - (t_l / root_l) * ft_l / fc_l)
                root_l = torch.minimum(
                    torch.maximum(root_l - f0_l / fc_l, lo_l), hi_l)
        else:
            u_l = torch.zeros_like(root_l)

    # root <= b_halfspace (calcul.f:191): b_hs for the frozen truncation is
    # layer mm-1's attenuated + flattened shear velocity, gathered
    idx_h = (mm_l - 1).long()
    lnt_l = (torch.log(cfg.t_base / t_l) / math.pi if cfg.atten
             else torch.zeros_like(t_l))
    gat = lambda a: a.gather(0, idx_h)  # noqa: E731
    bhs_l = gat(model_T[1]) * (1.0 + gat(model_T[3]) * lnt_l) * gat(model_T[5])
    ok_l = ok_l & (root_l <= bhs_l)

    zero = torch.zeros_like(root_l)
    c_out = torch.where(ok_l, root_l, zero)
    u_out = torch.where(ok_l, u_l, zero)
    # (P*nmodes, B) -> (B, P, nmodes)
    out = lambda x: x.reshape(P, nmodes, B).permute(2, 0, 1)  # noqa: E731
    return out(c_out), out(u_out), out(ok_l)


def _nanmedian(x):
    """Median along axis 0 ignoring NaNs, as ``np.nanmedian`` and
    ``jnp.nanmedian`` compute it: an even count averages the two middle
    values ((lo + hi) * 0.5; ``torch.nanmedian`` returns the lower one);
    an all-NaN column gives NaN."""
    n = (~torch.isnan(x)).sum(dim=0)
    s = torch.sort(x, dim=0).values              # NaNs sort last
    take = lambda i: s.gather(0, i.clamp(min=0)[None])[0]  # noqa: E731
    med = (take((n - 1) // 2) + take(n // 2)) * 0.5
    return torch.where(n > 0, med, torch.full_like(med, math.nan))


def surf_forward_joint(h, vp, vs, rho, qsinv, periods, nlay,
                       cfg: SurfConfig = SurfConfig(),
                       cfg_love: SurfConfig | None = None,
                       nsub: int = 512, wseed_nscan: int = 8,
                       wseed_backoff: int = 4, wseed_coarse: int = 0):
    """Joint Rayleigh + Love curves with calibrated cross-wave seeding.

    Counterpart of the JAX package's ``surf_forward_joint``.  The
    reference computes both waves independently (``fast_surf.f:2-5``);
    here the Love roots of the same model seed the Rayleigh solve:

      1. solve Love cold (``cfg_love``, default ``cfg``);
      2. cold-solve Rayleigh on a strided ``nsub``-model calibration
         subset (``nbisect=3``, no group velocity) and take the
         per-period median offset ``median(cL - cR)`` over valid lanes;
      3. solve Rayleigh for the whole batch through the fused ``c_warm``
         sweep seeded at ``cL - offset`` with a ``wseed_nscan * dc``
         window (backoff ``wseed_backoff * dc``, probe step
         ``wseed_coarse * dc``, 0 = ``cfg.coarse``).

    Lanes whose window misses fall back to the cold chain, and a period
    with no valid calibration lane has a NaN offset, whose seed the
    sweep never accepts, so the roots are those of the independent
    solve to refinement tolerance.  The JAX package runs the scheme on
    its Pallas backends only; the port runs it on both of its backends
    (``"plain"`` is the counterpart of ``pallas_interpret``: the same
    algorithm).  ``cfg.nmodes != 1`` takes two independent solves.

    Returns ``(cR, uR, okR, cL, uL, okL)``, each ``(B, P, nmodes)``.
    """
    cfg_l = cfg_love if cfg_love is not None else cfg
    args = (h, vp, vs, rho, qsinv, periods, nlay)
    if cfg.nmodes != 1:
        return (*surf_forward_batch(*args, wave="rayleigh", cfg=cfg),
                *surf_forward_batch(*args, wave="love", cfg=cfg_l))
    cL, uL, okL = surf_forward_batch(*args, wave="love", cfg=cfg_l)

    B = h.shape[0]
    ns = min(nsub, B)
    stride = max(B // ns, 1)
    sub = lambda x: x[0:stride * ns:stride].contiguous()  # noqa: E731
    periods = torch.as_tensor(periods, device=h.device)
    nlay = torch.as_tensor(nlay, device=h.device).to(torch.int32).expand(B)
    per_sub = sub(periods) if periods.dim() == 2 else periods
    # calibration: bracket-accuracy roots are plenty for a median offset
    cRs, _, okRs = surf_forward_batch(
        *map(sub, (h, vp, vs, rho, qsinv)), per_sub, sub(nlay),
        wave="rayleigh", cfg=replace(cfg, compute_group=False, nbisect=3))
    d = sub(cL)[:, :, 0] - cRs[:, :, 0]                       # (ns, P)
    valid = sub(okL)[:, :, 0] & okRs[:, :, 0]
    offs = _nanmedian(torch.where(valid, d, torch.full_like(d, math.nan)))
    c_pred = torch.where(okL[:, :, 0], cL[:, :, 0] - offs[None, :],
                         torch.zeros_like(cL[:, :, 0]))
    cfg_seed = replace(cfg, wseed_nscan=wseed_nscan,
                       wseed_backoff=wseed_backoff, wseed_coarse=wseed_coarse)
    cR, uR, okR = surf_forward_batch(*args, wave="rayleigh", cfg=cfg_seed,
                                     c_warm=c_pred)
    return cR, uR, okR, cL, uL, okL


# ---- the single-model solve on the eager oracle (ops/secular.py) -------


def _secular_fn(wave, assoc=False):
    """F(c, t, mdl, mm) of the eager oracle, ``mdl = (a, b, rho, d)``
    (L,) or (..., L) arrays broadcast against c's batch shape; ``assoc``
    takes the tree-product form of :mod:`.secular_assoc`."""
    def model(c, mdl, mm):
        shp = torch.broadcast_shapes(c.shape, mm.shape, mdl[0].shape[:-1])
        return [x.expand(*shp, x.shape[-1]) for x in mdl]

    ray, lov = ((rayleigh_secular_assoc, love_secular_assoc) if assoc
                else (rayleigh_secular, love_secular))
    if wave in RAYLEIGH_NAMES:
        return lambda c, t, mdl, mm: ray(c, t, *model(c, mdl, mm), mm)
    if wave in ("love", "lov", "L"):
        return lambda c, t, mdl, mm: lov(c, t, *model(c, mdl, mm)[1:], mm)
    raise ValueError(f"unknown wave type: {wave}")


def _model_at_period(t, vp, vs, rho, qsinv, fac, cfg: SurfConfig):
    """Attenuated + flattened model arrays (a, b, rho, d) at the periods
    ``t`` (calcul.f:112-133): (..., L) for t of shape (...)."""
    if cfg.atten:
        a_t, b_t = attenuation_rescale(vp, vs, qsinv, t[..., None],
                                       cfg.t_base)
    else:
        a_t, b_t = vp, vs
    return (a_t * fac.vel_fac, b_t * fac.vel_fac, rho * fac.rho_fac,
            fac.h_flat)


def _first_flip(F, cs, t, mdl, nlay, cfg: SurfConfig):
    """Evaluate F on the c-grid ``cs`` (one batch axis); return the first
    sign-change interval (index, found, closure layers)."""
    b, d = mdl[1], mdl[3]
    mms = effective_halfspace(cs, t, b, d, nlay, cfg.fact)
    sgn = _sign(F(cs, t, mdl, mms))
    # search window: stop at c >= b(mmax) + 0.3 (calcul.f:165-167)
    within = cs < (b[mms - 1] + 0.3)
    cand = (sgn[:-1] != sgn[1:]) & within[1:]
    return torch.argmax(cand.to(torch.int8)), cand.any(), mms


def _bracket(F, c_start, t, mdl, nlay, cfg: SurfConfig, nscan: int,
             coarse: int):
    """First sign change above ``c_start``, narrowed to a dc-wide cell.

    Sweeps a ``coarse * dc`` grid spanning ``nscan * dc``, then re-scans
    the hit cell at ``dc``.  Returns ``(c_lo, found, mm)``: the root lies
    in ``[c_lo, c_lo + dc]`` and ``mm`` is the truncation frozen at the
    bracket's upper end (the NEVILL convention, calcul.f:156-172).
    """
    dc = cfg.dc
    ladder = lambda n: torch.arange(  # noqa: E731
        n, dtype=c_start.dtype, device=c_start.device)
    if coarse > 1:
        k = max(nscan // coarse, 1)
        cs = c_start + (coarse * dc) * ladder(k + 1)
        ic, found_c, _ = _first_flip(F, cs, t, mdl, nlay, cfg)
        cs = cs[ic] + dc * ladder(coarse + 1)
        i, found_f, mms = _first_flip(F, cs, t, mdl, nlay, cfg)
        found = found_c & found_f
    else:
        cs = c_start + dc * ladder(nscan + 1)
        i, found, mms = _first_flip(F, cs, t, mdl, nlay, cfg)
    # reject brackets whose root would sit above the halfspace shear
    # velocity (calcul.f:191); c_lo <= b_hs keeps roots within one dc
    found = found & (cs[i] <= mdl[1][mms[i + 1] - 1])
    return cs[i], found, mms[i + 1]


def _group_velocity(F, root, t, mdl, mm):
    """u = c / (1 - (T/c) F_T/F_c): implicit differentiation at the root,
    by two forward-mode tangents with the attenuated + flattened ``mdl``
    held fixed (the reference's variational convention, surfa.f
    LEIGEN/REIGEN).  The secular function's renormalisation scale is
    detached, so its tangent drops out as ``stop_gradient``'s does."""
    from torch.func import jvp

    _, f_c = jvp(lambda cc: F(cc, t, mdl, mm), (root,),
                 (torch.ones_like(root),))
    _, f_t = jvp(lambda tt: F(root, tt, mdl, mm), (t,),
                 (torch.ones_like(t),))
    f_c = torch.where(f_c.abs() > 0, f_c, torch.ones_like(f_c))
    return root / (1.0 - (t / root) * f_t / f_c)


def surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                 wave: str = "rayleigh", cfg: SurfConfig = SurfConfig()):
    """Dispersion curves for one padded layered model, with overtones.

    Counterpart of the JAX package's single-model ``surf_forward``, on
    the eager oracle: every secular evaluation is a loop over layers of
    PyTorch ops in the inputs' dtype, on their device (no kernel), or
    with ``cfg.backend == "xla_assoc"`` the tree-product form of
    :mod:`.secular_assoc` (any other backend is ignored).  Phase 1
    brackets each (period, mode) in turn (the cold first period, warm
    starts ``warm_backoff * dc`` below the previous bracket, overtones
    0.1 dc above a 12-iteration estimate of the previous mode's root, a
    cold rescue pass when a sparse period list outruns the warm window),
    phase 2 refines every lane at once by Illinois, phase 3 takes u from
    forward-mode tangents.

    Args:
      h, vp, vs, rho, qsinv: (L,) padded model; layer ``nlay-1`` is the
        halfspace, pads replicate it with h = 0.  ``qsinv`` is 1/Qs.
      periods: (P,) periods in seconds, ascending.
      nlay:    number of real layers including the halfspace.
      wave:    'rayleigh' or 'love'.
      cfg:     :class:`SurfConfig`.

    Returns (c, u, valid), each (P, nmodes); c and u are 0 where not
    found.  ``valid`` costs one host sync (the rescue pass's test).
    """
    dtype, device = h.dtype, h.device
    periods = torch.as_tensor(periods, dtype=dtype, device=device)
    nl = torch.as_tensor(nlay, device=device).reshape(())
    kind = 1 if wave in ("love", "lov", "L") else 2
    h_eff, fac = model_preamble(h, nl, kind, cfg.flat)
    F = _secular_fn(wave, assoc=cfg.backend == "xla_assoc")
    nmodes, P, dc = cfg.nmodes, periods.shape[0], cfg.dc

    def chain(ok):
        return _mode_chain(ok, -1) if nmodes > 1 else ok

    def initial_c(t):
        c1 = _initial_c(h_eff[None], vs[None], qsinv[None], nl[None],
                        t[None], wave, cfg)
        return c1.to(dtype).expand(nmodes)

    # ================= phase 1: bracket every (period, mode) ============
    def bracket_period(t, starts, nscan, coarse0):
        """dc-wide brackets for all modes at one period."""
        mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
        c_los, mms, founds = [], [], []
        root_est = None
        for iq in range(nmodes):
            start = starts[iq]
            if iq > 0:
                # overtones start 0.1 dc above the previous mode's
                # 12-iteration root estimate (the duplicate-mode guard;
                # coarse sweeps are for the fundamental only)
                start = torch.maximum(start, root_est + 0.1 * dc)
            c_lo, found, mm = _bracket(F, start, t, mdl, nl, cfg, nscan,
                                       coarse0 if iq == 0 else 1)
            if iq < nmodes - 1:
                root_est = _illinois(lambda c: F(c, t, mdl, mm),  # noqa
                                     c_lo, c_lo + dc, 12)
            c_los.append(c_lo)
            mms.append(mm)
            founds.append(found)
        return torch.stack(c_los), torch.stack(mms), torch.stack(founds)

    # first period cold, then the warm-started chain (lax.scan in JAX)
    starts0 = initial_c(periods[0])
    lo0, mm0, ok0 = bracket_period(periods[0], starts0, cfg.nscan_first,
                                   cfg.coarse_first)
    ok0 = chain(ok0)
    rows = [(lo0, mm0, ok0)]
    c_start = torch.where(ok0, lo0 - cfg.warm_backoff * dc, starts0)
    alive = ok0
    for p in range(1, P):
        lok, mmk, okk = bracket_period(periods[p], c_start, cfg.nscan,
                                       cfg.coarse)
        okk = chain(okk & alive)
        c_start = torch.where(okk, lok - cfg.warm_backoff * dc, c_start)
        alive = okk
        rows.append((lok, mmk, okk))
    c_lo, mm, ok = (torch.stack(x) for x in zip(*rows))     # (P, nmodes)

    if P > 1 and not bool(ok.all()):
        # ---- rescue pass: a sparse period list can move the root farther
        # than the warm window reaches; re-bracket every (period, mode)
        # from a cold start and take it where the warm chain failed
        cold = [bracket_period(t, initial_c(t), cfg.nscan_first,
                               cfg.coarse_first) for t in periods]
        lo_c, mm_c, ok_c = (torch.stack(x) for x in zip(*cold))
        ok_c = chain(ok_c)
        use = ~ok & ok_c
        ok = chain(ok | ok_c)
        c_lo = torch.where(use, lo_c, c_lo)
        mm = torch.where(use, mm_c, mm)

    # ================= phase 2: refine all lanes at once ================
    KL, L = P * nmodes, h.shape[-1]
    t_l = periods.repeat_interleave(nmodes)
    lo_l, mm_l, ok_l = c_lo.reshape(KL), mm.reshape(KL), ok.reshape(KL)
    mdls = tuple(x.expand(KL, L) for x in
                 _model_at_period(t_l, vp, vs, rho, qsinv, fac, cfg))
    root_l = _illinois(lambda c: F(c, t_l, mdls, mm_l), lo_l, lo_l + dc,
                       cfg.nbisect)
    # root must not exceed the halfspace shear velocity (calcul.f:191)
    b_hs_l = mdls[1].gather(1, (mm_l - 1)[:, None])[:, 0]
    ok_l = ok_l & (root_l <= b_hs_l)

    # ================= phase 3: group velocity ===========================
    if cfg.compute_group:
        u_l = _group_velocity(F, root_l, t_l, mdls, mm_l)
    else:
        u_l = torch.zeros_like(root_l)
    zero = torch.zeros_like(root_l)
    out = lambda x: x.reshape(P, nmodes)  # noqa: E731
    return (out(torch.where(ok_l, root_l, zero)),
            out(torch.where(ok_l, u_l, zero)), out(ok_l))


def _rayleigh_at_roots(fn, h, vp, vs, rho, qsinv, periods, nlay,
                       cfg: SurfConfig):
    """``fn(c, t, a, b, rho, d, mm)`` of the Rayleigh model at each root of
    :func:`surf_forward` (0 where not found), with (c, valid)."""
    c_all, _, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                                    wave="rayleigh",
                                    cfg=replace(cfg, compute_group=False))
    periods = torch.as_tensor(periods, dtype=h.dtype, device=h.device)
    nl = torch.as_tensor(nlay, device=h.device).reshape(())
    _, fac = model_preamble(h, nl, 2, cfg.flat)
    t_l = periods.repeat_interleave(cfg.nmodes)
    c_l, ok_l = c_all.reshape(-1), ok_all.reshape(-1)
    mdl = tuple(x.expand(t_l.shape[0], h.shape[-1]) for x in
                _model_at_period(t_l, vp, vs, rho, qsinv, fac, cfg))
    mm = effective_halfspace(c_l, t_l, mdl[1], mdl[3], nl, cfg.fact)
    c_safe = torch.where(ok_l, c_l, mdl[1][:, 0] + 0.5)
    val = fn(c_safe, t_l, *mdl, mm)
    val = torch.where(ok_l, val, torch.zeros_like(val))
    return val.reshape(c_all.shape), c_all, ok_all


def surf_ellipticity(h, vp, vs, rho, qsinv, periods, nlay,
                     cfg: SurfConfig = SurfConfig()):
    """Rayleigh surface H/V ellipticity curves (DLTAR4 mup=2 capability):
    the roots of :func:`surf_forward`, then the ellipticity ratio at each
    (``surfa.f:360-364``).  Returns (ell, c, valid), each (P, nmodes)."""
    return _rayleigh_at_roots(rayleigh_ellipticity, h, vp, vs, rho, qsinv,
                              periods, nlay, cfg)


def surf_amplitude(h, vp, vs, rho, qsinv, periods, nlay,
                   cfg: SurfConfig = SurfConfig()):
    """Rayleigh amplitude-response curves (DLTAR4 mup=3 capability): the
    e2-seeded closure magnitude at each root (``surfa.f:366-371``),
    modulated by the water-column standing-wave factor under a liquid
    top; renormalised per layer, so only relative amplitudes across
    nearby (c, T) are meaningful.  Returns (amp, c, valid), each
    (P, nmodes)."""
    return _rayleigh_at_roots(rayleigh_amplitude, h, vp, vs, rho, qsinv,
                              periods, nlay, cfg)

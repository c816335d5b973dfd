"""Secular functions on a (K, B) lane grid: the solver's four kernels.

Counterpart of the JAX package's ``ops/pallas_secular.py``.  Each of its
TPU kernels is a CUDA C++ kernel here (``csrc/secular_lanes.cu``,
per-lane arithmetic in ``csrc/secular_lane.cuh``):

  ==========================  =============================================
  wrapper                     replaces (pysurfinv_tpu/ops/pallas_secular.py)
  ==========================  =============================================
  ``secular_lanes``           ``secular_lanes`` (``_rayleigh_kernel``,
                              ``_love_kernel``): F with the dynamic
                              4-wavelength truncation walk
  ``secular_lanes_frozen``    ``secular_lanes_frozen`` (``_frozen_kernel``):
                              F at a pinned closure layer
  ``secular_lanes_grad``      ``secular_lanes_grad`` (``_rayleigh_grad_kernel``,
                              ``_love_grad_kernel``): (F, dF/dc, dF/dT)
  ``refine_lanes``            ``refine_lanes`` (``_refine_kernel``):
                              Illinois + clamped Newton + group velocity,
                              one call per refinement (a float Illinois
                              kernel and a dual-number Newton kernel)
  ==========================  =============================================

Lane contract (shared by all four): lanes are (K, B) — K trial c or
period rows, B models; the model arrays are transposed to (L, B): vp,
vs, rho, qsi (= 1/Qs), h_flat, vel_fac, rho_fac; ``nlay`` is (B,) int32;
``mm_frozen`` is (K, B) int32 with 0 = dynamic truncation and >= 1 the
1-based closure layer (NEVILL convention).

Each wrapper dispatches on the device of its inputs: CPU tensors run the
plain PyTorch version (any float dtype), CUDA tensors launch the kernel
(float32 only) or raise — nothing falls back.  ``backend="plain"``
forces the plain version on any device and ``backend="kernel"`` forces
the kernel.  Each wrapper counts its kernel launches in ``.launches``.

The plain versions compute what the TPU kernels compute, at the same
renormalisation points: a Python loop over layers, each step vectorised
over the lanes with ``torch.where`` selects (never a multiplicative
blend — the unapplied deep layers overflow ``exp`` to inf, and inf * 0
is NaN).  They are not the eager path of :mod:`.secular`, which
renormalises elsewhere and shares only sign(F) and F_T/F_c with them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pysurfinv_tpu_torch.ops._cuda_build import (  # noqa: F401
    BUILD_DIR, CSRC, NVCC_FLAGS, _launched, _nvcc, _resolve, build_library)

TWO_PI = 6.283185307179586
ACCUR = 1e-8  # regime-switch tolerance, surfa.f:191-192

RAYLEIGH_NAMES = ("rayleigh", "ray", "R")


def _is_rayleigh(wave):
    if wave in RAYLEIGH_NAMES:
        return True
    if wave in ("love", "lov", "L"):
        return False
    raise ValueError(f"unknown wave type: {wave}")


# ---------------------------------------------------------------------------
# Per-layer updates, shared by the plain versions (pallas_secular.py:86-239)
# ---------------------------------------------------------------------------

def _where(cond, a, b):
    """torch.where that accepts Python scalars on either side."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def _pq(r, wd):
    """Branchless (r*sin, sin/r, cos) for one signed wavenumber regime."""
    ev = r < -ACCUR
    osc = r > ACCUR
    pm = wd * r
    pm_ev = _where(ev, pm, 0.0)
    pm_osc = _where(osc, pm, 0.0)
    r_safe = _where(r.abs() > ACCUR, r, 1.0)
    e = torch.exp(pm_ev)
    einv = 1.0 / e
    sh, ch = 0.5 * (e - einv), 0.5 * (e + einv)
    sn, cs = torch.sin(pm_osc), torch.cos(pm_osc)
    rsin = _where(ev, -r * sh, _where(osc, r * sn, 0.0))
    sinr = _where(ev, sh / r_safe, _where(osc, sn / r_safe, wd))
    cosx = _where(ev, ch, _where(osc, cs, 1.0))
    return rsin, sinr, cosx


def _wavenumbers(c, a, b):
    """Signed ra, rb and g, g1 (surfa.f:211-258); liquid-safe."""
    csq = c * c
    arga = 1.0 - csq / (a * a)
    ra_abs = torch.sqrt(arga.abs())
    ra = torch.where(arga > 0.0, -ra_abs, ra_abs)
    liquid = b.abs() <= ACCUR
    b_safe = _where(liquid, 1.0, b)
    argb = 1.0 - csq / (b_safe * b_safe)
    rb_abs = torch.sqrt(argb.abs())
    rb = torch.where(argb > 0.0, -rb_abs, rb_abs)
    g = 2.0 * b_safe * b_safe / csq
    return ra, rb, g, g - 1.0, liquid


def _ray_prop(cv, tv, b1, b2, b3, b4, b5, a_l, b_l, rho_l, d_l):
    """Unscaled Dunkin 5-vector update through one layer (surfa.f:259-335)."""
    csq = cv * cv
    wvno = TWO_PI / (cv * tv)

    ra, rb, g, g1, liquid = _wavenumbers(cv, a_l, b_l)
    wd = wvno * d_l
    rsinp, sinpr, cosp = _pq(ra, wd)
    rsinq, sinqr, cosq = _pq(rb, wd)

    rhoc = rho_l * csq
    rr = rsinp * rsinq
    ss = sinpr * sinqr
    cc = cosp * cosq
    rs1 = rsinp * cosq
    rs2 = sinqr * cosp
    rs3 = sinpr * cosq
    rs4 = rsinq * cosp
    gm = 2.0 * g - 1.0
    gs = g * g
    g1s = g1 * g1
    ccm = 1.0 - cc
    gg1 = g * g1
    rhocs = rhoc * rhoc
    suu = gs * rr + g1s * ss
    inv_rhoc = 1.0 / rhoc

    e11 = (2.0 * gs - gm) * cc - suu - 2.0 * gg1
    e12 = -(rs1 + rs2) * inv_rhoc
    e13 = -2.0 * (gm * ccm + g1 * ss + g * rr) * inv_rhoc
    e14 = (rs3 + rs4) * inv_rhoc
    e15 = (2.0 * ccm + rr + ss) * inv_rhoc * inv_rhoc
    e21 = rhoc * (g1s * rs3 + gs * rs4)
    e22 = cc
    e23 = 2.0 * (g * rs4 + g1 * rs3)
    e24 = sinpr * rsinq
    e31 = rhoc * (gg1 * gm * ccm + g1s * g1 * ss + gs * g * rr)
    e32 = g1 * rs2 + g * rs1
    e33 = 1.0 + 2.0 * (2.0 * gg1 * ccm + suu)
    e41 = -rhoc * (g1s * rs2 + gs * rs1)
    e42 = rsinp * sinqr
    e51 = rhocs * (2.0 * gs * g1s * ccm + gs * gs * rr + g1s * g1s * ss)

    # liquid-surface-layer override (surfa.f:216-251); a multiplicative
    # mask as on the TPU — liquid layers are shallow, their entries finite
    e11 = torch.where(liquid, cosp, e11)
    e21 = torch.where(liquid, rhoc * sinpr, e21)
    liq0 = (~liquid).to(e11.dtype)
    e12, e13, e14, e15 = (x * liq0 for x in (e12, e13, e14, e15))
    e22, e23, e24 = (x * liq0 for x in (e22, e23, e24))
    e31, e32, e33 = (x * liq0 for x in (e31, e32, e33))
    e41, e42, e51 = (x * liq0 for x in (e41, e42, e51))

    bb1 = e11 * b1 + e12 * b2 + e13 * b3 + e14 * b4 + e15 * b5
    bb2 = e21 * b1 + e22 * b2 + e23 * b3 + e24 * b4 - e14 * b5
    bb3 = (e31 * b1 + e32 * b2 + e33 * b3 - 0.5 * e23 * b4
           + 0.5 * e13 * b5)
    bb4 = e41 * b1 + e42 * b2 - 2.0 * e32 * b3 + e22 * b4 - e12 * b5
    bb5 = e51 * b1 - e41 * b2 + 2.0 * e31 * b3 - e21 * b4 + e11 * b5
    return bb1, bb2, bb3, bb4, bb5


def _ray_closure(cv, b1, b2, b3, b4, b5, a_h, b_h, rho_h):
    """Halfspace closure -> secular value (surfa.f:340-354)."""
    csq = cv * cv
    ra_h, rb_h, g_h, g1_h, _ = _wavenumbers(cv, a_h, b_h)
    ra_h = _where(ra_h.abs() > ACCUR, ra_h, -ACCUR)
    den = rho_h * a_h * a_h
    gra = g_h * ra_h
    rba = rb_h - 1.0 / ra_h
    A11 = (-2.0 * rb_h * (b_h * b_h) / (a_h * a_h)
           + csq * (g1_h * g1_h) / ((a_h * a_h) * gra))
    A12 = -1.0 / (g_h * den)
    A13 = -rb_h / den + g1_h / (den * gra)
    A14 = rb_h / (den * gra)
    A15 = rba / ((rho_h * a_h) ** 2 * csq * g_h)
    return -(A11 * b1 + A12 * b2 + 2.0 * A13 * b3 + A14 * b4 + A15 * b5)


def _love_prop(cv, tv, ut, tt, b_l, rho_l, d_l):
    """Unscaled Haskell (u, stress) update through one layer
    (surfa.f:156-172); water layers are the caller's mask."""
    wvno = TWO_PI / (cv * tv)
    water = b_l.abs() <= ACCUR
    b_safe = _where(water, 1.0, b_l)
    rb = torch.sqrt(((cv / b_safe) ** 2 - 1.0).abs())
    hmu = rho_l * b_safe * b_safe
    q = -wvno * d_l * rb
    osc = (cv > b_safe) & (rb >= 1e-20)
    ev = (cv < b_safe) & (rb >= 1e-20)
    q_osc = _where(osc, q, 0.0)
    q_ev = _where(ev, q, 0.0)
    rb_safe = _where(rb >= 1e-20, rb, 1.0)
    eq = torch.exp(q_ev)  # q_ev <= 0
    shq, chq = 0.5 * (eq - 1.0 / eq), 0.5 * (eq + 1.0 / eq)
    sn = torch.sin(q_osc)
    y = _where(osc, sn / rb_safe, _where(ev, shq / rb_safe, -wvno * d_l))
    z = _where(osc, rb * sn, _where(ev, -rb * shq, 0.0))
    cosq = _where(osc, torch.cos(q_osc), _where(ev, chq, 1.0))
    eut = cosq * ut - y * tt / hmu
    ett = hmu * z * ut + cosq * tt
    return eut, ett


def _love_init(cv, b_h, rho_h):
    """Halfspace initial (u, stress) for Love (surfa.f:143-148)."""
    b_hs = _where(b_h.abs() > ACCUR, b_h, 1.0)
    rb_h = torch.sqrt(((cv / b_hs) ** 2 - 1.0).abs())
    return torch.ones_like(cv), rho_h * b_hs * b_hs * rb_h


def _renorm(xs, scale_of=None):
    """Divide every entry of ``xs`` by the max-abs of ``scale_of``
    (default ``xs``): the per-layer renormalisation, a constant for the
    tangents."""
    ref = xs if scale_of is None else scale_of
    scale = ref[0].abs()
    for x in ref[1:]:
        scale = torch.maximum(scale, x.abs())
    inv = 1.0 / _where(scale > 0.0, scale, 1.0)
    return tuple(x * inv for x in xs)


def _layer_model(model, lnt, atten):
    """Attenuated + flattened (a, b, rho, d) row accessor, rows (1, B)."""
    vp, vs, rho, qsi, hf, vf, rf = model

    def row(l):
        vp_l, vs_l = vp[l][None, :], vs[l][None, :]
        if atten:
            qsq = qsi[l][None, :] * lnt
            vp_s = _where(vp_l.abs() > 0, vp_l, 1.0)
            qpq = qsq * 1.33333333 * (vs_l / vp_s) ** 2
            a_l = vp_l * (1.0 + qpq) * vf[l][None, :]
            b_l = vs_l * (1.0 + qsq) * vf[l][None, :]
        else:
            a_l = vp_l * vf[l][None, :]
            b_l = vs_l * vf[l][None, :]
        return a_l, b_l, rho[l][None, :] * rf[l][None, :], hf[l][None, :]

    return row


def _lnt(t_base, tm, atten):
    return torch.log(t_base / tm) / math.pi if atten else torch.zeros_like(tm)


def _halfspace_rows(row, mmf, L):
    """(a, b, rho) of each lane's frozen closure layer ``mmf - 1``; lanes
    whose ``mmf - 1`` lies outside 0..L-2 take the padded row L-1."""
    a_h, b_h, rho_h, _ = (x.expand(mmf.shape) for x in row(L - 1))
    for l in range(L - 1):
        a_l, b_l, rho_l, _ = row(l)
        cap = mmf - 1 == l
        a_h = torch.where(cap, a_l, a_h)
        b_h = torch.where(cap, b_l, b_h)
        rho_h = torch.where(cap, rho_l, rho_h)
    return a_h, b_h, rho_h


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def secular_lanes_plain(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                        rho_fac, nlay, wave="rayleigh", fact=4.0,
                        t_base=1.0, atten=True, t_mat=None):
    """F(c, T) with the inline dynamic truncation walk, any float dtype.

    Transcribes ``_rayleigh_kernel``/``_love_kernel``
    (pallas_secular.py:242-523).  ``t`` drives the wavenumbers and the
    truncation, ``t_mat`` (default ``t``) the attenuation rescale.
    Returns (F, b_hs, mm): the secular values, the closure halfspace's
    shear velocity and the 1-based closure layer (int32), each (K, B).
    """
    rayleigh = _is_rayleigh(wave)
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    L = vp.shape[0]
    tm = t if t_mat is None else t_mat
    mmf = mm_frozen
    nl = nlay.to(torch.int32)[None, :]
    frozen = mmf > 0
    dmax = fact * c * t
    row = _layer_model(model, _lnt(t_base, tm, atten), atten)

    zero, one = torch.zeros_like(c), torch.ones_like(c)
    closed = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
    pending = closed.clone()
    csum = zero
    a_h, b_h, rho_h = one, one, one
    mm = nl.expand(c.shape).to(torch.int32)
    bvec = (one, zero, zero, zero, zero)
    for l in range(L - 1):
        a_l, b_l, rho_l, d_l = row(l)
        # ---- inline truncation walk (surfa.f:92-106) ----
        cond = (c < b_l) & (l < nl)
        csum = csum + torch.where(cond, d_l, zero)
        exceed = cond & (csum > dmax)
        close_dyn = pending | exceed | (l == nl - 1)
        close_sel = torch.where(frozen, mmf - 1 == l, close_dyn)
        close_now = ~closed & close_sel & (l >= 1)
        pending = pending | (exceed & (l == 0))
        a_h = torch.where(close_now, a_l, a_h)
        b_h = torch.where(close_now, b_l, b_h)
        rho_h = torch.where(close_now, rho_l, rho_h)
        mm = torch.where(close_now, torch.full_like(mm, l + 1), mm)
        closed = closed | close_now
        if rayleigh:
            nb = _ray_prop(c, t, *bvec, a_l, b_l, rho_l, d_l)
            bvec = _renorm(tuple(torch.where(closed, o, p)
                                 for p, o in zip(nb, bvec)))

    # lanes never closed in 0..L-2 close with the padded halfspace row
    a_last, b_last, rho_last, _ = row(L - 1)
    a_h = torch.where(closed, a_h, a_last)
    b_h = torch.where(closed, b_h, b_last)
    rho_h = torch.where(closed, rho_h, rho_last)
    mm = torch.where(closed, mm, nl.expand(c.shape).to(torch.int32))

    if rayleigh:
        F = _ray_closure(c, *bvec, a_h, b_h, rho_h)
    else:
        F = _love_upward(c, t, mm, row, L, b_h, rho_h)
    return F, b_h, mm


def _love_upward(c, t, mm, row, L, b_h, rho_h):
    """Love pass 2: propagate (ut, tt) from the halfspace up to the
    surface through layers l <= mm-2 that are not water."""
    ut, tt = _renorm(_love_init(c, b_h, rho_h))
    for l in range(L - 2, -1, -1):
        _, b_l, rho_l, d_l = row(l)
        apply = (l <= mm - 2) & ~(b_l.abs() <= ACCUR)
        pu, ps = _love_prop(c, t, ut, tt, b_l, rho_l, d_l)
        ut, tt = _renorm((torch.where(apply, pu, ut),
                          torch.where(apply, ps, tt)))
    return -tt


def secular_lanes_frozen_plain(c, t, mm_frozen, vp, vs, rho, qsi, h_flat,
                               vel_fac, rho_fac, nlay, wave="rayleigh",
                               t_base=1.0, atten=True):
    """F at the pinned closure layer ``mm_frozen`` (>= 2), no truncation
    walk; transcribes ``_frozen_kernel`` (pallas_secular.py:1086-1111)."""
    rayleigh = _is_rayleigh(wave)
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    L = vp.shape[0]
    mmf = mm_frozen
    row = _layer_model(model, _lnt(t_base, t, atten), atten)
    a_h, b_h, rho_h = _halfspace_rows(row, mmf, L)
    if not rayleigh:
        return _love_upward(c, t, mmf, row, L, b_h, rho_h)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    bvec = (one, zero, zero, zero, zero)
    for l in range(L - 1):
        a_l, b_l, rho_l, d_l = row(l)
        apply = l < mmf - 1
        nb = _ray_prop(c, t, *bvec, a_l, b_l, rho_l, d_l)
        bvec = _renorm(tuple(torch.where(apply, p, o)
                             for p, o in zip(nb, bvec)))
    return _ray_closure(c, *bvec, a_h, b_h, rho_h)


def secular_lanes_grad_plain(c, t, mm_frozen, vp, vs, rho, qsi, h_flat,
                             vel_fac, rho_fac, nlay, wave="rayleigh",
                             t_base=1.0, atten=True):
    """(F, dF/dc, dF/dT) at frozen truncation (``mm_frozen`` >= 2).

    Transcribes ``_rayleigh_grad_kernel``/``_love_grad_kernel``
    (pallas_secular.py:616-775): forward-mode tangents in c and T through
    each layer update (dual tensors of ``torch.autograd.forward_ad``;
    the same derivative formulas as ``torch.func.jvp`` at a third of its
    dispatch cost), with the attenuated material held at ``t`` (the
    tangent in T runs through the wavenumbers only) and the
    renormalisation factor taken from the primal values.
    """
    import torch.autograd.forward_ad as fwAD

    def jvp(fn, primals, tangents):
        with fwAD.dual_level():
            out = fn(*(fwAD.make_dual(p, d)
                       for p, d in zip(primals, tangents)))
            out = [fwAD.unpack_dual(o) for o in
                   (out if isinstance(out, tuple) else (out,))]
            prim = tuple(o.primal for o in out)
            tang = tuple(torch.zeros_like(o.primal) if o.tangent is None
                         else o.tangent for o in out)
        if len(out) == 1:
            return prim[0], tang[0]
        return prim, tang

    rayleigh = _is_rayleigh(wave)
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    L = vp.shape[0]
    mmf = mm_frozen
    row = _layer_model(model, _lnt(t_base, t, atten), atten)
    a_h, b_h, rho_h = _halfspace_rows(row, mmf, L)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    # both tangent directions in one jvp: a leading axis of 2 holds the
    # c-direction (index 0) and the T-direction (index 1); the primal is
    # the same in both copies
    two = lambda x, y: torch.stack([x, y])  # noqa: E731
    c2, t2 = two(c, c), two(t, t)
    dir_c, dir_t = two(one, zero), two(zero, one)
    zero2 = two(zero, zero)

    def sel(apply, new, old):
        return tuple(torch.where(apply, p, o) for p, o in zip(new, old))

    if rayleigh:
        b = (two(one, one),) + (zero2,) * 4
        db = (zero2,) * 5
        for l in range(L - 1):
            a_l, b_l, rho_l, d_l = row(l)
            apply = l < mmf - 1

            def prop(x, tv, *bv, a_l=a_l, b_l=b_l, rho_l=rho_l, d_l=d_l):
                return _ray_prop(x, tv, *bv, a_l, b_l, rho_l, d_l)

            nb, ndb = jvp(prop, (c2, t2, *b), (dir_c, dir_t, *db))
            nb, ndb = sel(apply, nb, b), sel(apply, ndb, db)
            out = _renorm(nb + ndb, scale_of=nb)
            b, db = out[0:5], out[5:10]

        F, dF = jvp(lambda x, *bv: _ray_closure(x, *bv, a_h, b_h, rho_h),
                    (c2, *b), (dir_c, *db))
        return F[0], dF[0], dF[1]

    (ut, tt), (dut, dtt) = jvp(lambda x: _love_init(x, b_h, rho_h),
                               (c2,), (dir_c,))
    ut, tt, dut, dtt = _renorm((ut, tt, dut, dtt), scale_of=(ut, tt))
    for l in range(L - 2, -1, -1):
        _, b_l, rho_l, d_l = row(l)
        apply = (l <= mmf - 2) & ~(b_l.abs() <= ACCUR)

        def prop(x, tv, u, s, b_l=b_l, rho_l=rho_l, d_l=d_l):
            return _love_prop(x, tv, u, s, b_l, rho_l, d_l)

        new, dnew = jvp(prop, (c2, t2, ut, tt), (dir_c, dir_t, dut, dtt))
        new = sel(apply, new, (ut, tt)) + sel(apply, dnew, (dut, dtt))
        ut, tt, dut, dtt = _renorm(new, scale_of=new[:2])
    return -tt[0], -dtt[0], -dtt[1]


def _sgn(x):
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def refine_lanes_plain(lo, hi, t, mm_frozen, vp, vs, rho, qsi, h_flat,
                       vel_fac, rho_fac, nlay, wave="rayleigh", t_base=1.0,
                       atten=True, n_ill=6, n_newton=2, compute_group=True):
    """Brackets -> roots (and group velocities), any float dtype.

    Transcribes ``_refine_kernel`` (pallas_secular.py:906-1024): ``n_ill
    + 2`` Illinois iterations, the first two evaluating the ends, then
    ``n_newton`` bracket-clamped Newton steps, the last of which only
    evaluates; its tangents give u = c / (1 - (T/c) F_T/F_c).  The
    evaluations are :func:`secular_lanes_frozen_plain` and
    :func:`secular_lanes_grad_plain`; the state updates are the TPU
    kernel's selects, in its order.  Returns ``(root, u)``; ``u`` is
    zeros when ``compute_group`` is False or ``n_newton`` is 0.
    """
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    kw = dict(wave=wave, t_base=t_base, atten=atten)
    F_of = lambda x: secular_lanes_frozen_plain(  # noqa: E731
        x, t, mm_frozen, *model, nlay, **kw)
    zero = torch.zeros_like(lo)
    flo = F_of(lo)
    fhi = F_of(hi)
    side = zero
    for _ in range(n_ill):
        denom = fhi - flo
        denom = torch.where(denom.abs() > 0, denom, 1.0)
        x_int = (lo * fhi - hi * flo) / denom
        bad = ~((x_int > lo) & (x_int < hi))
        x = torch.where(bad, 0.5 * (lo + hi), x_int)
        fx = F_of(x)
        same_lo = _sgn(fx) == _sgn(flo)
        nlo = torch.where(same_lo, x, lo)
        nflo = torch.where(same_lo, fx, flo)
        nhi = torch.where(same_lo, hi, x)
        nfhi = torch.where(same_lo, fhi, fx)
        nfhi = torch.where(same_lo & (side == -1), 0.5 * nfhi, nfhi)
        nflo = torch.where(~same_lo & (side == 1), 0.5 * nflo, nflo)
        side = torch.where(same_lo, -1.0, 1.0).to(lo.dtype)
        lo, hi, flo, fhi = nlo, nhi, nflo, nfhi
    denom = fhi - flo
    denom = torch.where(denom.abs() > 0, denom, 1.0)
    x = torch.minimum(torch.maximum((lo * fhi - hi * flo) / denom, lo), hi)
    u = zero
    slo = _sgn(flo)
    for j in range(n_newton):
        F, Fc, Ft = secular_lanes_grad_plain(x, t, mm_frozen, *model, nlay,
                                             **kw)
        same_lo = _sgn(F) == slo
        lo = torch.where(same_lo, x, lo)
        hi = torch.where(same_lo, hi, x)
        fc_safe = torch.where(Fc.abs() > 0, Fc, 1.0)
        xn = x - F / fc_safe
        bad = ~((xn > lo) & (xn < hi))
        xn = torch.where(bad, 0.5 * (lo + hi), xn)
        if compute_group:
            u = x / (1.0 - (t / x) * (Ft / fc_safe))
        if j < n_newton - 1:
            x = xn
    return x, u


# ---------------------------------------------------------------------------
# CUDA build and launch
# ---------------------------------------------------------------------------

SOURCES = ("secular_lane.cuh", "secular_lanes.cu")


@functools.cache
def kernel_library():
    """Build (once per source hash) and load the secular-lane kernels:
    ``(lib, info)`` as :func:`build_library` returns them."""
    lib, info = build_library("secular_lanes", SOURCES, "secular_lanes.cu")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    model = [P] * 7  # vp, vs, rho, qsi, h_flat, vel_fac, rho_fac
    lib.secular_lanes_launch.argtypes = (
        [P, P, P, P] + model + [P, P, P, P, I, I, I, I, F, F, I, P])
    lib.secular_lanes_frozen_launch.argtypes = (
        [P, P, P] + model + [P, I, I, I, I, F, I, P])
    lib.secular_lanes_grad_launch.argtypes = (
        [P, P, P] + model + [P, P, P, I, I, I, I, F, I, P])
    lib.refine_lanes_launch.argtypes = (
        [P, P, P, P] + model + [P, P, P, I, I, I, I, F, I, I, I, I, P])
    for fn in (lib.secular_lanes_launch, lib.secular_lanes_frozen_launch,
               lib.secular_lanes_grad_launch, lib.refine_lanes_launch):
        fn.restype = ctypes.c_int
    return lib, info


def _check_lanes(name, c, lanes, model, nlay):
    """Validate the kernels' inputs; raise on anything they do not take."""
    if not c.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors "
                         f"(got {c.device}); CPU tensors take the plain "
                         "version")
    if c.dim() != 2:
        raise ValueError(f"{name}: lanes must be (K, B), got {tuple(c.shape)}")
    K, B = c.shape
    for x in lanes:
        if x.dtype != torch.float32 or x.shape != c.shape:
            raise TypeError(f"{name}: the kernel takes float32 (K, B) lanes, "
                            f"got {x.dtype} {tuple(x.shape)}")
    if model[0].dim() != 2 or model[0].shape[1] != B:
        raise ValueError(f"{name}: model arrays must be (L, B={B}), got "
                         f"{tuple(model[0].shape)}")
    L = model[0].shape[0]
    if L < 2:
        raise ValueError(f"{name}: need at least 2 layers, got L={L}")
    for x in model:
        if x.dtype != torch.float32 or tuple(x.shape) != (L, B):
            raise TypeError(f"{name}: model arrays must be float32 (L, B), "
                            f"got {x.dtype} {tuple(x.shape)}")
    if nlay.dtype != torch.int32 or tuple(nlay.shape) != (B,):
        raise TypeError(f"{name}: nlay must be int32 (B,), got {nlay.dtype} "
                        f"{tuple(nlay.shape)}")
    for x in (*lanes, *model, nlay):
        if x.device != c.device:
            raise ValueError(f"{name}: all inputs must be on {c.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return K, B, L


def _check_mm(name, mm, c):
    if mm.dtype != torch.int32 or mm.shape != c.shape:
        raise TypeError(f"{name}: mm_frozen must be int32 "
                        f"{tuple(c.shape)}, got {mm.dtype} "
                        f"{tuple(mm.shape)}")
    if mm.device != c.device or not mm.is_contiguous():
        raise ValueError(f"{name}: mm_frozen must be contiguous on "
                         f"{c.device}")


def _ptrs(*xs):
    return [x.data_ptr() for x in xs]


def secular_lanes(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                  rho_fac, nlay, wave="rayleigh", fact=4.0, t_base=1.0,
                  atten=True, t_mat=None, backend="auto"):
    """Secular values on a (K, B) lane grid with dynamic truncation.

    Args:
      c, t:        (K, B) trial phase velocities and periods.
      mm_frozen:   (K, B) int32; 0 = dynamic truncation, >0 = pinned
                   1-based closure layer count (NEVILL convention).
      vp..rho_fac: (L, B) transposed padded model arrays; ``h_flat``,
                   ``vel_fac``, ``rho_fac`` from :mod:`.flatten`.
      nlay:        (B,) int32 real-layer counts.
      t_mat:       (K, B) period of the attenuation rescale (default t).

    Returns (F, b_hs, mm), each (K, B); ``mm`` is int32.
    """
    args = (c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac, rho_fac,
            nlay)
    if not _resolve("secular_lanes", backend, c):
        return secular_lanes_plain(*args, wave=wave, fact=fact,
                                   t_base=t_base, atten=atten, t_mat=t_mat)
    tm = t if t_mat is None else t_mat
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    K, B, L = _check_lanes("secular_lanes", c, (c, t, tm), model, nlay)
    _check_mm("secular_lanes", mm_frozen, c)
    lib, _ = kernel_library()
    F = torch.empty_like(c)
    bhs = torch.empty_like(c)
    mm = torch.empty_like(mm_frozen)
    err = lib.secular_lanes_launch(
        *_ptrs(c, t, tm, mm_frozen, *model, nlay, F, bhs, mm),
        K, B, L, int(_is_rayleigh(wave)), float(fact), float(t_base),
        int(atten), torch.cuda.current_stream(c.device).cuda_stream)
    _launched("secular_lanes", err)
    secular_lanes.launches += 1
    return F, bhs, mm


def secular_lanes_frozen(c, t, mm_frozen, vp, vs, rho, qsi, h_flat,
                         vel_fac, rho_fac, nlay, wave="rayleigh",
                         t_base=1.0, atten=True, backend="auto"):
    """Secular values on a (K, B) lane grid at frozen truncation.

    Same contract as :func:`secular_lanes` with ``mm_frozen >= 2``
    everywhere, returning only F — the refinement-phase fast path.
    """
    args = (c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac, rho_fac,
            nlay)
    if not _resolve("secular_lanes_frozen", backend, c):
        return secular_lanes_frozen_plain(*args, wave=wave, t_base=t_base,
                                          atten=atten)
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    K, B, L = _check_lanes("secular_lanes_frozen", c, (c, t), model, nlay)
    _check_mm("secular_lanes_frozen", mm_frozen, c)
    lib, _ = kernel_library()
    F = torch.empty_like(c)
    err = lib.secular_lanes_frozen_launch(
        *_ptrs(c, t, mm_frozen, *model, F), K, B, L,
        int(_is_rayleigh(wave)), float(t_base), int(atten),
        torch.cuda.current_stream(c.device).cuda_stream)
    _launched("secular_lanes_frozen", err)
    secular_lanes_frozen.launches += 1
    return F


def secular_lanes_grad(c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                       rho_fac, nlay, wave="rayleigh", t_base=1.0,
                       atten=True, backend="auto"):
    """(F, dF/dc, dF/dT) on a (K, B) lane grid at frozen truncation.

    ``mm_frozen`` must be >= 2 everywhere.  dF/dT is the partial through
    the wavenumbers only, with the attenuated material held at ``t`` —
    the fixed-material convention of the group velocity
    u = c / (1 - (T/c) F_T/F_c).
    """
    args = (c, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac, rho_fac,
            nlay)
    if not _resolve("secular_lanes_grad", backend, c):
        return secular_lanes_grad_plain(*args, wave=wave, t_base=t_base,
                                        atten=atten)
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    K, B, L = _check_lanes("secular_lanes_grad", c, (c, t), model, nlay)
    _check_mm("secular_lanes_grad", mm_frozen, c)
    lib, _ = kernel_library()
    F = torch.empty_like(c)
    Fc = torch.empty_like(c)
    Ft = torch.empty_like(c)
    err = lib.secular_lanes_grad_launch(
        *_ptrs(c, t, mm_frozen, *model, F, Fc, Ft), K, B, L,
        int(_is_rayleigh(wave)), float(t_base), int(atten),
        torch.cuda.current_stream(c.device).cuda_stream)
    _launched("secular_lanes_grad", err)
    secular_lanes_grad.launches += 1
    return F, Fc, Ft


def refine_lanes(lo, hi, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac,
                 rho_fac, nlay, wave="rayleigh", t_base=1.0, atten=True,
                 n_ill=6, n_newton=2, compute_group=True, backend="auto"):
    """Refine (K, B) brackets to roots + group velocities in one call.

    Args mirror :func:`secular_lanes_frozen`; ``lo``/``hi`` bound each
    lane's root (a sign change inside is the caller's contract — lanes
    without one converge somewhere inside and are masked by the caller's
    ``ok``).  Returns ``(root, u)``; ``u`` is zeros when
    ``compute_group`` is False or ``n_newton`` is 0.  On the card the
    call runs the Illinois phase and, for ``n_newton`` > 0, the Newton
    phase as two kernels back to back, handing 16 bytes a lane over in
    a scratch buffer; it counts as one launch.
    """
    args = (lo, hi, t, mm_frozen, vp, vs, rho, qsi, h_flat, vel_fac, rho_fac,
            nlay)
    kw = dict(wave=wave, t_base=t_base, atten=atten, n_ill=n_ill,
              n_newton=n_newton, compute_group=compute_group)
    if not _resolve("refine_lanes", backend, lo):
        return refine_lanes_plain(*args, **kw)
    if n_ill < 0 or n_newton < 0:
        raise ValueError("refine_lanes: n_ill and n_newton must be >= 0")
    model = (vp, vs, rho, qsi, h_flat, vel_fac, rho_fac)
    K, B, L = _check_lanes("refine_lanes", lo, (lo, hi, t), model, nlay)
    _check_mm("refine_lanes", mm_frozen, lo)
    lib, _ = kernel_library()
    root = torch.empty_like(lo)
    u = torch.empty_like(lo)
    # the Illinois phase's hand-over to the Newton phase: (lo, hi, x,
    # sgn F(lo)) a lane
    state = (torch.empty((K, B, 4), dtype=lo.dtype, device=lo.device)
             if n_newton > 0 else None)
    err = lib.refine_lanes_launch(
        *_ptrs(lo, hi, t, mm_frozen, *model, root, u),
        None if state is None else state.data_ptr(), K, B, L,
        int(_is_rayleigh(wave)), float(t_base), int(atten), int(n_ill),
        int(n_newton), int(compute_group),
        torch.cuda.current_stream(lo.device).cuda_stream)
    _launched("refine_lanes", err)
    refine_lanes.launches += 1
    return root, u


secular_lanes.launches = 0
secular_lanes_frozen.launches = 0
secular_lanes_grad.launches = 0
refine_lanes.launches = 0
KERNELS = (secular_lanes, secular_lanes_frozen, secular_lanes_grad,
           refine_lanes)


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0

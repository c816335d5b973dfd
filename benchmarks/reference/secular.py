"""Plain reference of the fundamental-mode Rayleigh dispersion solve.

A frozen, self-contained copy of the physics the port solves (the
Dunkin reduced-delta secular function with its liquid-layer branch and
halfspace closure, the four-wavelength halfspace truncation, the
per-period attenuation rescale and the Biswas earth flattening), with a
root search of its own: every (model, period) lane is scanned cold from
the first period's starting velocity in 0.01 km/s steps, the first sign
change is cut down by multisection at the truncation frozen at the
bracket's upper end, and the group velocity is the central difference
of two such roots at periods 1e-4 apart with the attenuated model held
fixed.  Nothing here imports the program.

The ``dtype`` of :func:`solve` sets the precision of the secular
function's arithmetic (the brackets stay float64): float64 for the
reference, the precision below the program's for the control.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 6.283185307179586
ACCUR = 1e-8
R0 = 6371.0
H_MIN = 1e-3
FACT = 4.0
DC = 0.01
PWR_RAYLEIGH = 2.275
N_SUB = 32          # multisection points per round
N_ROUNDS = 7        # 0.01 km/s / 32**7 = 3e-13 km/s, then one secant
FD_REL = 1e-4       # relative period step of the group difference
F64 = torch.float64


def flatten(h, nlay):
    """(h_flat, vel_fac, rho_fac, h_eff) of (M, L) padded models: thin
    finite layers (h <= 1e-3) and everything from the halfspace index on
    are zero-thickness rows; the halfspace and pads carry its factors."""
    idx = torch.arange(h.shape[-1], device=h.device)
    nl = nlay[:, None]
    fin = idx < nl - 1
    h_eff = torch.where(fin & (h > H_MIN), h, torch.zeros_like(h))
    z_top = torch.cumsum(h_eff, dim=-1) - h_eff
    r_top, r_bot = R0 - z_top, R0 - (z_top + h_eff)
    thin = h_eff <= 0.0
    r_top_s = torch.where(thin, torch.full_like(h, R0), r_top)
    r_bot_s = torch.where(thin, torch.full_like(h, R0 / math.e), r_bot)
    f = torch.log(r_top_s / r_bot_s)
    dif = (1.0 / r_bot_s - 1.0 / r_top_s) * R0 / f
    qqq = ((r_top_s ** PWR_RAYLEIGH - r_bot_s ** PWR_RAYLEIGH)
           / (f * R0 ** PWR_RAYLEIGH * PWR_RAYLEIGH))
    one = torch.ones_like(h)
    ok = fin & ~thin
    vel = torch.where(ok, dif, torch.where(fin, one, R0 / r_top))
    rho = torch.where(ok, qqq, torch.where(fin, one, (r_top / R0) ** PWR_RAYLEIGH))
    return torch.where(ok, R0 * f, torch.zeros_like(h)), vel, rho, h_eff


class Lanes:
    """(model, period) lanes of M padded float64 models at P periods:
    per-layer rows (L, B) with B = M * P, model-major."""

    def __init__(self, h, vp, vs, rho, qsinv, nlay, periods):
        M, L = h.shape
        P = periods.shape[-1]
        per = periods.expand(M, P) if periods.dim() == 1 else periods
        hf, vf, rf, h_eff = flatten(h, nlay)
        rep = lambda x: x.repeat_interleave(P, dim=0).T.contiguous()  # noqa
        self.M, self.P, self.L = M, P, L
        self.vp, self.vs, self.rho, self.qsi = map(rep, (vp, vs, rho, qsinv))
        self.hf, self.vf, self.rf = map(rep, (hf, vf, rf))
        self.nl = nlay.repeat_interleave(P).to(torch.int64)
        self.t = per.reshape(-1).to(F64)
        self.c0 = self._initial_c(h_eff, vs, qsinv, nlay).repeat_interleave(P)

    def _initial_c(self, h_eff, vs, qsinv, nlay):
        """The first period's starting velocity (fast_surf.f:156-171):
        0.5 km/s under water, else 0.9x the top layer's shear velocity
        at that period's attenuation."""
        idx = torch.arange(self.L, device=vs.device)
        nl = nlay[:, None]
        act = ((idx < nl - 1) & (h_eff > H_MIN)) | (idx == nl - 1)
        first = torch.argmax(act.to(torch.int8), dim=-1)
        second = torch.argmax((act & (idx > first[:, None])).to(torch.int8),
                              dim=-1)
        at = lambda x, i: x.gather(-1, i[:, None])[:, 0]  # noqa: E731
        water = at(vs, first) < 0.1
        il = torch.where(water, second, first)
        t1 = self.t.reshape(self.M, self.P)[:, 0]
        c1 = 0.9 * at(vs, il) * (1.0 + at(qsinv, il) * torch.log(1.0 / t1)
                                 / math.pi)
        return torch.where(water, torch.full_like(c1, 0.5), c1)

    def rows(self, t_mat, dtype):
        """Attenuated + flattened (a, b, rho, d) rows (L, B) at the
        attenuation periods ``t_mat`` (B,)."""
        lnt = torch.log(1.0 / t_mat) / math.pi
        qsq = self.qsi * lnt
        vp_s = torch.where(self.vp.abs() > 0, self.vp, torch.ones_like(self.vp))
        qpq = qsq * 1.33333333 * (self.vs / vp_s) ** 2
        a = self.vp * (1.0 + qpq) * self.vf
        b = self.vs * (1.0 + qsq) * self.vf
        return tuple(x.to(dtype) for x in (a, b, self.rho * self.rf, self.hf))


def _pq(r, wd):
    ev, osc = r < -ACCUR, r > ACCUR
    pm = wd * r
    zero, one = torch.zeros_like(pm), torch.ones_like(pm)
    pm_ev = torch.where(ev, pm, zero)
    pm_osc = torch.where(osc, pm, zero)
    r_safe = torch.where(r.abs() > ACCUR, r, one)
    e = torch.exp(pm_ev)
    einv = 1.0 / e
    sh, ch = 0.5 * (e - einv), 0.5 * (e + einv)
    sn, cs = torch.sin(pm_osc), torch.cos(pm_osc)
    rsin = torch.where(ev, -r * sh, torch.where(osc, r * sn, zero))
    sinr = torch.where(ev, sh / r_safe, torch.where(osc, sn / r_safe, wd))
    cosx = torch.where(ev, ch, torch.where(osc, cs, one))
    return rsin, sinr, cosx


def _wavenumbers(c, a, b):
    csq = c * c
    arga = 1.0 - csq / (a * a)
    ra_abs = torch.sqrt(arga.abs())
    ra = torch.where(arga > 0.0, -ra_abs, ra_abs)
    liquid = b.abs() <= ACCUR
    b_safe = torch.where(liquid, torch.ones_like(b), b)
    argb = 1.0 - csq / (b_safe * b_safe)
    rb_abs = torch.sqrt(argb.abs())
    rb = torch.where(argb > 0.0, -rb_abs, rb_abs)
    g = 2.0 * b_safe * b_safe / csq
    return ra, rb, g, g - 1.0, liquid


def _dunkin(c, t, bv, a, b, rho, d):
    """The Dunkin 5-vector through one layer (surfa.f:259-335)."""
    b1, b2, b3, b4, b5 = bv
    csq = c * c
    wvno = TWO_PI / (c * t)
    ra, rb, g, g1, liquid = _wavenumbers(c, a, b)
    wd = wvno * d
    rsinp, sinpr, cosp = _pq(ra, wd)
    rsinq, sinqr, cosq = _pq(rb, wd)
    rhoc = rho * csq
    rr, ss, cc = rsinp * rsinq, sinpr * sinqr, cosp * cosq
    rs1, rs2, rs3, rs4 = rsinp * cosq, sinqr * cosp, sinpr * cosq, rsinq * cosp
    gm, gs, g1s = 2.0 * g - 1.0, g * g, g1 * g1
    ccm, gg1 = 1.0 - cc, g * g1
    suu = gs * rr + g1s * ss
    e11 = (2.0 * gs - gm) * cc - suu - 2.0 * gg1
    e12 = -(rs1 + rs2) / rhoc
    e13 = -2.0 * (gm * ccm + g1 * ss + g * rr) / rhoc
    e14 = (rs3 + rs4) / rhoc
    e15 = (2.0 * ccm + rr + ss) / (rhoc * rhoc)
    e21 = rhoc * (g1s * rs3 + gs * rs4)
    e22 = cc
    e23 = 2.0 * (g * rs4 + g1 * rs3)
    e24 = sinpr * rsinq
    e31 = rhoc * (gg1 * gm * ccm + g1s * g1 * ss + gs * g * rr)
    e32 = g1 * rs2 + g * rs1
    e33 = 1.0 + 2.0 * (2.0 * gg1 * ccm + suu)
    e41 = -rhoc * (g1s * rs2 + gs * rs1)
    e42 = rsinp * sinqr
    e51 = rhoc * rhoc * (2.0 * gs * g1s * ccm + gs * gs * rr + g1s * g1s * ss)
    # a liquid layer (surfa.f:216-251) keeps only its acoustic terms
    solid = (~liquid).to(c.dtype)
    e11 = torch.where(liquid, cosp, e11)
    e21 = torch.where(liquid, rhoc * sinpr, e21)
    e12, e13, e14, e15, e22, e23, e24, e31, e32, e33, e41, e42, e51 = (
        x * solid for x in (e12, e13, e14, e15, e22, e23, e24, e31, e32,
                            e33, e41, e42, e51))
    return (e11 * b1 + e12 * b2 + e13 * b3 + e14 * b4 + e15 * b5,
            e21 * b1 + e22 * b2 + e23 * b3 + e24 * b4 - e14 * b5,
            e31 * b1 + e32 * b2 + e33 * b3 - 0.5 * e23 * b4 + 0.5 * e13 * b5,
            e41 * b1 + e42 * b2 - 2.0 * e32 * b3 + e22 * b4 - e12 * b5,
            e51 * b1 - e41 * b2 + 2.0 * e31 * b3 - e21 * b4 + e11 * b5)


def _closure(c, bv, a, b, rho):
    """Halfspace closure (surfa.f:340-354): the secular value."""
    csq = c * c
    ra, rb, g, g1, _ = _wavenumbers(c, a, b)
    ra = torch.where(ra.abs() > ACCUR, ra, torch.full_like(ra, -ACCUR))
    den = rho * a * a
    gra = g * ra
    A11 = -2.0 * rb * (b * b) / (a * a) + csq * (g1 * g1) / ((a * a) * gra)
    A12 = -1.0 / (g * den)
    A13 = -rb / den + g1 / (den * gra)
    A14 = rb / (den * gra)
    A15 = (rb - 1.0 / ra) / ((rho * a) ** 2 * csq * g)
    return -(A11 * bv[0] + A12 * bv[1] + 2.0 * A13 * bv[2] + A14 * bv[3]
             + A15 * bv[4])


def secular(lanes, c, t, t_mat, mm_frozen=None, dtype=F64):
    """F(c) on (K, B) trial velocities ``c`` of the B lanes, with the
    wavenumbers at periods ``t`` and the attenuation at ``t_mat`` (each
    (B,)).  ``mm_frozen`` None walks the truncation (surfa.f:92-106);
    else the closure layer count is pinned, (K, B).  Returns (F, b_hs,
    mm), F and b_hs in float64."""
    a_r, b_r, rho_r, d_r = lanes.rows(t_mat, dtype)
    c, t = c.to(dtype), t.to(dtype)[None].expand(c.shape)
    L = a_r.shape[0]
    nl = lanes.nl[None]
    dmax = FACT * c * t
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    closed = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
    pending = closed.clone()
    csum = zero
    a_h = b_h = rho_h = one
    mm = nl.expand(c.shape).clone()
    bv = (one, zero, zero, zero, zero)
    for m in range(L - 1):
        a, b, rho, d = a_r[m][None], b_r[m][None], rho_r[m][None], d_r[m][None]
        cond = (c < b) & (m < nl)
        csum = csum + torch.where(cond, d, zero)
        exceed = cond & (csum > dmax)
        if mm_frozen is None:
            close = pending | exceed | (m == nl - 1)
        else:
            close = mm_frozen - 1 == m
        now = ~closed & close & (m >= 1)
        pending = pending | (exceed & (m == 0))
        a_h = torch.where(now, a.expand(c.shape), a_h)
        b_h = torch.where(now, b.expand(c.shape), b_h)
        rho_h = torch.where(now, rho.expand(c.shape), rho_h)
        mm = torch.where(now, torch.full_like(mm, m + 1), mm)
        closed = closed | now
        nb = _dunkin(c, t, bv, a, b, rho, d)
        nb = tuple(torch.where(closed, o, p) for p, o in zip(nb, bv))
        scale = nb[0].abs()
        for x in nb[1:]:
            scale = torch.maximum(scale, x.abs())
        inv = 1.0 / torch.where(scale > 0.0, scale, one)
        bv = tuple(x * inv for x in nb)
    a_h = torch.where(closed, a_h, a_r[L - 1][None].expand(c.shape))
    b_h = torch.where(closed, b_h, b_r[L - 1][None].expand(c.shape))
    rho_h = torch.where(closed, rho_h, rho_r[L - 1][None].expand(c.shape))
    mm = torch.where(closed, mm, nl.expand(c.shape))
    return _closure(c, bv, a_h, b_h, rho_h).to(F64), b_h.to(F64), mm


def _sign(x):
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _multisection(lanes, lo, hi, t, t_mat, mm, dtype):
    """Cut each bracket [lo, hi] (B,) at the pinned truncation ``mm``
    down to float64 resolution; the last step is a secant.  Lanes
    without a sign change in the bracket keep lo."""
    j = torch.arange(N_SUB + 1, dtype=F64, device=lo.device)[:, None] / N_SUB
    mmk = mm[None].expand(N_SUB + 1, -1)
    for _ in range(N_ROUNDS):
        xs = lo[None] + (hi - lo)[None] * j
        F, _, _ = secular(lanes, xs, t, t_mat, mmk, dtype)
        s = _sign(F)
        flip = s[:-1] != s[1:]
        i = torch.argmax(flip.to(torch.int8), dim=0)
        has = flip.any(0)
        nlo = xs.gather(0, i[None])[0]
        nhi = xs.gather(0, (i + 1)[None])[0]
        lo = torch.where(has, nlo, lo)
        hi = torch.where(has, nhi, hi)
        f_lo = torch.where(has, F.gather(0, i[None])[0], F[0])
        f_hi = torch.where(has, F.gather(0, (i + 1)[None])[0], F[-1])
    den = f_hi - f_lo
    den = torch.where(den.abs() > 0, den, torch.ones_like(den))
    x = (lo * f_hi - hi * f_lo) / den
    return torch.minimum(torch.maximum(x, lo), hi)


def phase_roots(lanes, dtype=F64, block=48):
    """Fundamental-mode roots of every lane: the first 0.01 km/s cell
    above the starting velocity whose secular values change sign below
    the closure halfspace's shear velocity + 0.3 km/s (calcul.f:165-167),
    kept only when its lower end does not exceed that velocity
    (calcul.f:191); refined at the truncation of the cell's upper end.
    Returns (c, ok, mm), each (B,)."""
    B = lanes.t.shape[0]
    dev = lanes.t.device
    t = lanes.t
    _, b_r, _, _ = lanes.rows(t, F64)
    c_top = float(b_r.max()) + 0.3 + DC
    n_steps = int(math.ceil((c_top - float(lanes.c0.min())) / DC)) + 1
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    done = found.clone()
    lo = torch.zeros(B, dtype=F64, device=dev)
    mm_hi = torch.zeros(B, dtype=torch.int64, device=dev)
    prev = None  # (c, F, b_hs, mm) of the previous block's last row
    for k0 in range(0, n_steps, block):
        ks = torch.arange(k0, min(k0 + block, n_steps), dtype=F64,
                          device=dev)
        cs = lanes.c0[None] + DC * ks[:, None]
        F, bhs, mm = secular(lanes, cs, t, t, None, dtype)
        if prev is not None:
            cs, F, bhs, mm = (torch.cat([p[None], x]) for p, x in
                              zip(prev, (cs, F, bhs, mm)))
        prev = (cs[-1], F[-1], bhs[-1], mm[-1])
        s = _sign(F)
        cand = (s[:-1] != s[1:]) & (cs[1:] < bhs[1:] + 0.3)
        hit = cand.any(0) & ~done
        i = torch.argmax(cand.to(torch.int8), dim=0)
        c_lo = cs.gather(0, i[None])[0]
        ok = c_lo <= bhs.gather(0, (i + 1)[None])[0]
        lo = torch.where(hit, c_lo, lo)
        mm_hi = torch.where(hit, mm.gather(0, (i + 1)[None])[0], mm_hi)
        found = torch.where(hit, ok, found)
        done = done | hit
        if bool(done.all()):
            break
    root = _multisection(lanes, lo, lo + DC, t, t, mm_hi, dtype)
    # root <= the frozen closure's shear velocity (calcul.f:191)
    _, bhs, _ = secular(lanes, root[None], t, t, mm_hi[None], dtype)
    found = found & (root <= bhs[0])
    return torch.where(found, root, torch.zeros_like(root)), found, mm_hi


def group_velocity(lanes, c, mm, dtype=F64):
    """u = c / (1 + (T/c) dc/dT) with dc/dT the central difference of
    the roots at T (1 +- 1e-4), the attenuated model and the truncation
    held at the phase root's (the variational convention)."""
    t = lanes.t
    out = []
    for sgn in (1.0, -1.0):
        tt = t * (1.0 + sgn * FD_REL)
        lo, hi = c - 0.5 * DC, c + 0.5 * DC
        out.append(_multisection(lanes, lo, hi, tt, t, mm, dtype))
    dcdt = (out[0] - out[1]) / (2.0 * FD_REL * t)
    return c / (1.0 + (t / c) * dcdt)


def solve(h, vp, vs, rho, qsinv, nlay, periods, group=False, dtype=F64):
    """Phase (and group) velocities of M float64 models at P periods:
    (c, u, ok), each (M, P); u is None without ``group``."""
    lanes = Lanes(h, vp, vs, rho, qsinv, nlay, periods)
    c, ok, mm = phase_roots(lanes, dtype)
    u = None
    if group:
        safe = torch.where(ok, c, lanes.c0 + 1.0)
        u = torch.where(ok, group_velocity(lanes, safe, mm, dtype),
                        torch.zeros_like(c))
        u = u.reshape(lanes.M, lanes.P)
    shape = (lanes.M, lanes.P)
    return c.reshape(shape), u, ok.reshape(shape)

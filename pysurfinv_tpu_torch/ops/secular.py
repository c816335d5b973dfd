"""Thomson–Haskell / Dunkin secular functions as masked layer loops.

Behavioural spec from the reference Fortran:

  * Love wave: 2x2 Haskell propagation of (displacement, stress) from the
    effective halfspace up to the free surface; the secular function is
    the negated surface stress (``surfa.f:135-183``, DLTAR1).
  * Rayleigh wave: Dunkin reduced-delta formulation — a 5-component
    subdeterminant vector propagated from the free surface down through
    the stack, closed with the halfspace condition (``surfa.f:185-372``,
    DLTAR4, dispersion branch mup=1), including the liquid-surface-layer
    branch (``surfa.f:216-251``).
  * Dynamic halfspace truncation: layers deeper than ``fact = 4``
    wavelengths of cumulative evanescent (c < vs) thickness are replaced
    by a halfspace (``surfa.f:92-106``).
  * Per-period physical-dispersion (attenuation) rescale of velocities
    (``calcul.f:121-130``) with t_base = 1 s.

This is the eager oracle in any dtype, the counterpart of the JAX
package's ``ops/secular.py``.  Every function broadcasts over leading
batch axes: ``c``/``t`` have the batch shape, model arrays ``(..., L)``,
``mmax`` is an integer tensor of the batch shape.  The conventions are
the JAX module's:

  * all branches are ``where`` masks; padded zero-thickness layers are
    exact identity updates;
  * the 5-vector / 2-vector state is renormalised by its max-abs every
    layer, with the scale detached so autograd derivatives are those of
    the unscaled recursion;
  * the unselected branch of every ``where`` is computed on clamped
    arguments (the double-where trick) so autograd stays NaN-free;
  * every layer's propagation matrix (Dunkin 5x5, Haskell 2x2) is formed
    at once, elementwise over the layer axis; the sequential loop only
    multiplies, selects and renormalises, a few PyTorch ops a layer.

The kernels in :mod:`pysurfinv_tpu_torch.ops.secular_lanes` renormalise
at other points, so they share only the sign of F and the ratio of its
partials with this module.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 6.283185307179586
ACCUR = 1e-8  # regime-switch tolerance, surfa.f:191-192


def attenuation_rescale(vp_ref, vs_ref, qsinv, t, t_base=1.0):
    """Physical-dispersion velocity rescale at period ``t``.

    calcul.f:121-130:  qsq = qsinv*ln(t_base/t)/pi,
    qpq = qsq*(4/3)*(vs_ref/vp_ref)^2, b = b_ref*(1+qsq), a = a_ref*(1+qpq).
    """
    qsq = qsinv * torch.log(t_base / t) / math.pi
    vp_safe = torch.where(vp_ref.abs() > 0, vp_ref, torch.ones_like(vp_ref))
    qpq = qsq * 1.33333333 * (vs_ref / vp_safe) ** 2
    return vp_ref * (1.0 + qpq), vs_ref * (1.0 + qsq)


def effective_halfspace(c, t, b, d, nlay, fact=4.0):
    """1-based effective layer count after 4-wavelength truncation.

    Mirrors DLTAR's idrop block (surfa.f:92-106): walk the stack, summing
    thicknesses of layers with c < vs; the first layer at which that sum
    exceeds ``fact * c * t`` becomes the halfspace.  Clamped to >= 2.
    """
    L = b.shape[-1]
    idx = torch.arange(L, device=b.device)
    c_ = torch.as_tensor(c)[..., None]
    dmax = fact * c_ * torch.as_tensor(t)[..., None]
    cond = (c_ < b) & (idx < torch.as_tensor(nlay, device=b.device)[..., None])
    csum = torch.cumsum(torch.where(cond, d, torch.zeros_like(d)), dim=-1)
    exceed = cond & (csum > dmax)
    first = torch.argmax(exceed.to(torch.int8), dim=-1) + 1
    m = torch.where(exceed.any(-1), first,
                    torch.as_tensor(nlay, device=b.device).to(first.dtype))
    return torch.clamp(m, min=2)


def _pq_terms(r, wd):
    """Branchless (r*sin, sin/r, cos) analogues for one wavenumber regime.

    Matches surfa.f:212-219 — ``r`` carries the reference sign convention
    (negative for evanescent, positive for oscillatory):
      r < 0:   rsin = -r*sinh(wd*r),  sinr = sinh(wd*r)/r,  cosx = cosh(wd*r)
      r > 0:   rsin =  r*sin(wd*r),   sinr = sin(wd*r)/r,   cosx = cos(wd*r)
      |r|~0:   rsin = 0,              sinr = wd,            cosx = 1
    """
    zero, one = torch.zeros_like(r), torch.ones_like(r)
    ev = r < -ACCUR
    osc = r > ACCUR
    pm = wd * r
    pm_ev = torch.where(ev, pm, zero)
    pm_osc = torch.where(osc, pm, zero)
    r_safe = torch.where(r.abs() > ACCUR, r, one)
    # sinh/cosh from one exp (surfa.f:267-269)
    e = torch.exp(pm_ev)
    einv = 1.0 / e
    sh, ch = 0.5 * (e - einv), 0.5 * (e + einv)
    sn, cs = torch.sin(pm_osc), torch.cos(pm_osc)
    rsin = torch.where(ev, -r * sh, torch.where(osc, r * sn, zero))
    sinr = torch.where(ev, sh / r_safe, torch.where(osc, sn / r_safe, wd))
    cosx = torch.where(ev, ch, torch.where(osc, cs, one))
    return rsin, sinr, cosx


def _vertical_wavenumbers(c, a, b):
    """Signed ra, rb and g, g1 (surfa.f:211-258); liquid-safe."""
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


def _dunkin_entries(c, csq, wvno, a_m, b_m, rho_m, d_m):
    """Per-layer Dunkin 5x5 subdeterminant entries (surfa.f:259-320),
    with the liquid-surface-layer override (surfa.f:216-251)."""
    ra, rb, g, g1, liquid = _vertical_wavenumbers(c, a_m, b_m)
    wd = wvno * d_m
    rsinp, sinpr, cosp = _pq_terms(ra, wd)
    rsinq, sinqr, cosq = _pq_terms(rb, wd)

    rhoc = rho_m * csq
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

    e = dict(
        e11=(2.0 * gs - gm) * cc - suu - 2.0 * gg1,
        e12=-(rs1 + rs2) / rhoc,
        e13=-2.0 * (gm * ccm + g1 * ss + g * rr) / rhoc,
        e14=(rs3 + rs4) / rhoc,
        e15=(2.0 * ccm + rr + ss) / rhocs,
        e21=rhoc * (g1s * rs3 + gs * rs4),
        e22=cc,
        e23=2.0 * (g * rs4 + g1 * rs3),
        e24=sinpr * rsinq,
        e31=rhoc * (gg1 * gm * ccm + g1s * g1 * ss + gs * g * rr),
        e32=g1 * rs2 + g * rs1,
        e33=1.0 + 2.0 * (2.0 * gg1 * ccm + suu),
        e41=-rhoc * (g1s * rs2 + gs * rs1),
        e42=rsinp * sinqr,
        e51=rhocs * (2.0 * gs * g1s * ccm + gs * gs * rr + g1s * g1s * ss),
    )
    zero = torch.zeros_like(e["e11"])
    for k in e:
        if k == "e11":
            e[k] = torch.where(liquid, cosp, e[k])
        elif k == "e21":
            e[k] = torch.where(liquid, rhoc * sinpr, e[k])
        else:
            e[k] = torch.where(liquid, zero, e[k])
    return e, liquid


def _dunkin_matrix(c, csq, wvno, a, b, rho, d):
    """(..., L, 5, 5) Dunkin update matrices of every layer of (..., L)
    model arrays at once (the symmetric 5-vector update, surfa.f:326-335),
    and the (..., L) liquid mask."""
    x = lambda v: v[..., None]  # noqa: E731  (batch -> layer axis)
    e, liquid = _dunkin_entries(x(c), x(csq), x(wvno), a, b, rho, d)
    rows = ((e["e11"], e["e12"], e["e13"], e["e14"], e["e15"]),
            (e["e21"], e["e22"], e["e23"], e["e24"], -e["e14"]),
            (e["e31"], e["e32"], e["e33"], -0.5 * e["e23"], 0.5 * e["e13"]),
            (e["e41"], e["e42"], -2.0 * e["e32"], e["e22"], -e["e12"]),
            (e["e51"], -e["e41"], 2.0 * e["e31"], -e["e21"], e["e11"]))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2), liquid


def _dunkin_closure(c, csq, a_h, b_h, rho_h, bvec):
    """Halfspace closure row applied to a propagated 5-vector
    (surfa.f:340-354)."""
    ra_h, rb_h, g_h, g1_h, _ = _vertical_wavenumbers(c, a_h, b_h)
    ra_h = torch.where(ra_h.abs() > ACCUR, ra_h,
                       torch.full_like(ra_h, -ACCUR))
    den = rho_h * a_h * a_h
    gra = g_h * ra_h
    rba = rb_h - 1.0 / ra_h
    A11 = (-2.0 * rb_h * (b_h * b_h) / (a_h * a_h)
           + csq * (g1_h * g1_h) / ((a_h * a_h) * gra))
    A12 = -1.0 / (g_h * den)
    A13 = -rb_h / den + g1_h / (den * gra)
    A14 = rb_h / (den * gra)
    A15 = rba / ((rho_h * a_h) ** 2 * csq * g_h)
    return (A11 * bvec[..., 0] + A12 * bvec[..., 1] + 2.0 * A13 * bvec[..., 2]
            + A14 * bvec[..., 3] + A15 * bvec[..., 4])


def _at(x, i):
    """x[..., i] for a per-batch integer index tensor ``i``."""
    return torch.gather(x, -1, i.long()[..., None])[..., 0]


def _renorm(new):
    """Divide by the detached max-abs (sign-preserving, AD-constant)."""
    scale = new.abs().amax(dim=-1, keepdim=True).detach()
    return new / torch.where(scale > 0.0, scale, torch.ones_like(scale))


def rayleigh_secular(c, t, a, b, rho, d, mmax):
    """Dunkin reduced-delta Rayleigh secular function (DLTAR4, mup=1).

    Args:
      c, t:  trial phase velocities and periods (batch shape).
      a, b, rho, d: (..., L) flattened+attenuated padded model arrays.
      mmax:  effective 1-based layer count (from ``effective_halfspace``).

    Returns the (renormalised) secular determinant; only its sign and the
    ratios of its partials at a root are meaningful.
    """
    c = torch.as_tensor(c, dtype=a.dtype)
    t = torch.as_tensor(t, dtype=a.dtype)
    mmax = torch.as_tensor(mmax, device=a.device)
    wvno = TWO_PI / (c * t)
    csq = c * c
    L = a.shape[-1]
    bshape = torch.broadcast_shapes(c.shape, a.shape[:-1], mmax.shape)
    bvec = torch.eye(5, dtype=a.dtype, device=a.device)[0].expand(
        bshape + (5,))
    M, _ = _dunkin_matrix(c, csq, wvno, a[..., :-1], b[..., :-1],
                          rho[..., :-1], d[..., :-1])
    for m in range(L - 1):
        new = (M[..., m, :, :] @ bvec[..., None])[..., 0]
        apply = (m < (mmax - 1))[..., None]
        bvec = _renorm(torch.where(apply, new, bvec))

    h = mmax - 1
    return -_dunkin_closure(c, csq, _at(a, h), _at(b, h), _at(rho, h), bvec)


def love_secular(c, t, b, rho, d, mmax):
    """Haskell Love-wave secular function (DLTAR1, mup=1).

    Propagates (transverse displacement, stress) from the effective
    halfspace (index mmax-1) up to the surface; water layers (vs = 0) are
    skipped (surfa.f:150-152).  Returns the negated surface stress.
    """
    c = torch.as_tensor(c, dtype=b.dtype)
    t = torch.as_tensor(t, dtype=b.dtype)
    mmax = torch.as_tensor(mmax, device=b.device)
    wvno = TWO_PI / (c * t)
    L = b.shape[-1]

    # Halfspace initial state (surfa.f:143-148).
    h = mmax - 1
    bh = _at(b, h)
    b_h = torch.where(bh.abs() > ACCUR, bh, torch.ones_like(bh))
    rb_h = torch.sqrt(((c / b_h) ** 2 - 1.0).abs())
    tt0 = _at(rho, h) * b_h * b_h * rb_h
    state = _renorm(torch.stack([torch.ones_like(tt0), tt0], dim=-1))

    # every layer's Haskell matrix at once (..., L-1), then the loop
    b_m, rho_m, d_m = b[..., :-1], rho[..., :-1], d[..., :-1]
    c_, wv = c[..., None], wvno[..., None]
    water = b_m.abs() <= ACCUR
    b_safe = torch.where(water, torch.ones_like(b_m), b_m)
    rb = torch.sqrt(((c_ / b_safe) ** 2 - 1.0).abs())
    hmu = rho_m * b_safe * b_safe
    q = -wv * d_m * rb
    # regimes (surfa.f:156-172)
    osc = (c_ > b_safe) & (rb >= 1e-20)
    ev = (c_ < b_safe) & (rb >= 1e-20)
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    q_osc = torch.where(osc, q, zero)
    q_ev = torch.where(ev, q, zero)
    rb_safe = torch.where(rb >= 1e-20, rb, one)
    eq = torch.exp(q_ev)  # q_ev <= 0
    shq, chq = 0.5 * (eq - 1.0 / eq), 0.5 * (eq + 1.0 / eq)
    y = torch.where(osc, torch.sin(q_osc) / rb_safe,
                    torch.where(ev, shq / rb_safe, -wv * d_m * one))
    z = torch.where(osc, rb * torch.sin(q_osc),
                    torch.where(ev, -rb * shq, zero))
    cosq = torch.where(osc, torch.cos(q_osc), torch.where(ev, chq, one))
    G = torch.stack([torch.stack([cosq, -y / hmu], dim=-1),
                     torch.stack([hmu * z, cosq], dim=-1)], dim=-2)
    idx = torch.arange(L - 1, device=b.device)
    apply = (idx <= (mmax[..., None] - 2)) & ~water
    for m in range(L - 2, -1, -1):
        new = (G[..., m, :, :] @ state[..., None])[..., 0]
        state = _renorm(torch.where(apply[..., m, None], new, state))
    return -state[..., 1]


def _dunkin_pair(c, t, a, b, rho, d, mmax):
    """Propagate the e2- and e3-seeded Dunkin recursions jointly.

    DLTAR4's mup=2/3 modes rerun the recursion from unit vectors e2 and
    e3 instead of e1, and skip liquid layers entirely (``surfa.f:196-207,
    218``).  Both 5-vectors share one scale factor (detached), so their
    ratio — the only quantity mup=2 consumes — is that of the unscaled
    recursions.
    """
    c = torch.as_tensor(c, dtype=a.dtype)
    t = torch.as_tensor(t, dtype=a.dtype)
    mmax = torch.as_tensor(mmax, device=a.device)
    wvno = TWO_PI / (c * t)
    csq = c * c
    L = a.shape[-1]
    bshape = torch.broadcast_shapes(c.shape, a.shape[:-1], mmax.shape)
    unit = torch.eye(5, dtype=a.dtype, device=a.device)
    uv = unit[:, 1:3].expand(bshape + (5, 2))   # columns: e2, e3 seeds
    M, liquid = _dunkin_matrix(c, csq, wvno, a[..., :-1], b[..., :-1],
                               rho[..., :-1], d[..., :-1])
    idx = torch.arange(L - 1, device=a.device)
    keep = (idx < (mmax[..., None] - 1)) & ~liquid
    for m in range(L - 1):
        new = torch.where(keep[..., m, None, None], M[..., m, :, :] @ uv, uv)
        scale = new.abs().amax(dim=(-2, -1), keepdim=True).detach()
        uv = new * (1.0 / torch.where(scale > 0.0, scale,
                                      torch.ones_like(scale)))
    u, v = uv[..., 0], uv[..., 1]

    h = mmax - 1
    a_h, b_h, rho_h = _at(a, h), _at(b, h), _at(rho, h)
    return (_dunkin_closure(c, csq, a_h, b_h, rho_h, u),
            _dunkin_closure(c, csq, a_h, b_h, rho_h, v))


def rayleigh_ellipticity(c, t, a, b, rho, d, mmax):
    """Surface H/V ellipticity at a Rayleigh root (DLTAR4, mup=2).

    ``surfa.f:360-364``: ellipticity = 0.5 * bb1(jump=3) / bb1(jump=2),
    evaluated at the dispersion root ``c``.
    """
    F2, F3 = _dunkin_pair(c, t, a, b, rho, d, mmax)
    F2 = torch.where(F2.abs() > 0, F2, torch.full_like(F2, ACCUR))
    return 0.5 * F3 / F2


def rayleigh_amplitude(c, t, a, b, rho, d, mmax):
    """Amplitude response |bb1| at a Rayleigh root (DLTAR4, mup=3).

    ``surfa.f:366-371``: the e2-seeded recursion's closure magnitude,
    modulated by the water-column standing-wave factor cos(wvno * d1 *
    sqrt(|c^2/a1^2 - 1|)) when the surface layer is liquid.  The
    magnitude is renormalised per layer, so only relative amplitudes
    across nearby (c, t) are meaningful.
    """
    F2, _ = _dunkin_pair(c, t, a, b, rho, d, mmax)
    amp = F2.abs()
    c = torch.as_tensor(c, dtype=a.dtype)
    liquid_top = b[..., 0].abs() <= ACCUR
    wvno = TWO_PI / (c * torch.as_tensor(t, dtype=a.dtype))
    ra = c / a[..., 0]
    rad = wvno * d[..., 0] * torch.sqrt((ra * ra - 1.0).abs())
    return torch.where(liquid_top, (amp * torch.cos(rad)).abs(), amp)

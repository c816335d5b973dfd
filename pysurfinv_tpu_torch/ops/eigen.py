"""Surface-wave eigenfunction depth profiles (SURF_PERTURB capability).

Counterpart of the JAX package's ``ops/eigen.py``.  The reference writes
displacement/stress eigenfunctions per (mode, period) from its RK4
integration (``senskernel-1.0/src/SURF_PERTURB/calcul_deep.f:254-349``
and the ``surfa.f`` REIGEN/LEIGEN machinery); here, as in the JAX
package:

  * each homogeneous layer's displacement-stress propagator is the
    matrix exponential of the P-SV (4x4) or SH (2x2) first-order system
    matrix (Aki & Richards, Quantitative Seismology, eqs. 7.28/7.24),
    ``torch.linalg.matrix_exp``;
  * propagation runs upward from the truncation halfspace, the
    numerically stable direction; for Rayleigh the two decaying
    halfspace solutions (P, SV) are propagated as a basis,
    re-orthonormalised by QR at every layer top, and combined by the
    free-surface traction condition (a 2x2 null vector at the root);
  * profiles are normalised to unit vertical (Rayleigh) or transverse
    (Love) displacement at the top of the SOLID stack — the free surface
    for solid models, the water/solid interface for ocean models
    (``surfa.f:709``, ``surfa.f:1051-1055``);
  * a surface water column couples to the Rayleigh problem through the
    impedance szz = tzz uz at the interface, from a downward acoustic
    pass of the embedded fluid system `_fluid_system4` (the reference's
    closed cosh/sinh water algebra, ``surfa.f:876-911``).

The JAX code vmaps one (period, mode) lane at a time; here every lane is
a leading batch axis of one computation, and each ``lax.scan`` over the
layers is a Python loop of batched PyTorch ops covering all lanes.  The
loops stop at the deepest lane's halfspace: below it every propagator is
the identity.  Everything runs in the inputs' dtype (float64 for
analysis) on their device, on the eager secular functions of the
single-model :func:`~pysurfinv_tpu_torch.ops.dispersion.surf_forward`;
no kernel.

QR's column signs may differ between LAPACK (CPU) and the card's
solver; the profiles do not depend on them (the null vector and the
back-solve absorb any column sign), only Q and R do.
"""

from __future__ import annotations

import torch

from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _model_at_period,
                                                surf_forward)
from pysurfinv_tpu_torch.ops.flatten import model_preamble
from pysurfinv_tpu_torch.ops.secular import effective_halfspace

TWO_PI = 6.283185307179586
R0_KM = 6371.0


def _matrix(rows):
    """(..., n, n) from n rows of n broadcastable tensors."""
    rows = [torch.broadcast_tensors(*r) for r in rows]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _psv_system(k, om, a, b, rho):
    """P-SV system matrix d/dz [ur, uz, s_zr, s_zz] (A&R eq. 7.28),
    (..., 4, 4) over the broadcast shape of the arguments."""
    mu = rho * b * b
    lam = rho * a * a - 2.0 * mu
    l2m = lam + 2.0 * mu
    zeta = 4.0 * mu * (lam + mu) / l2m
    ro2 = rho * om * om
    z = torch.zeros_like(k * mu)
    return _matrix([[z, k, 1.0 / mu, z],
                    [-k * lam / l2m, z, z, 1.0 / l2m],
                    [k * k * zeta - ro2, z, z, k * lam / l2m],
                    [z, -ro2, -k, z]])


def _sh_system(k, om, b, rho):
    """SH system matrix d/dz [ut, s_zt] (A&R eq. 7.24), (..., 2, 2)."""
    mu = rho * b * b
    z = torch.zeros_like(k * mu)
    return _matrix([[z, 1.0 / mu], [k * k * mu - om * om * rho, z]])


def _fluid_system4(k, om, a, rho):
    """Acoustic (liquid) layer embedded in the 4-component P-SV state.

    In a fluid sigma_zr = 0 and the horizontal displacement is slaved to
    the normal stress, ur = k szz / (rho om^2); the dynamics close on
    (uz, szz): uz' = -gamma^2 / (rho om^2) szz with gamma^2 = k^2 -
    om^2/a^2, szz' = -rho om^2 uz (the displacement-potential form the
    reference evaluates in closed cosh/sinh form, ``surfa.f:876-911``).
    A state on the fluid constraint stays on it, so water layers share
    the expm-sampling and Boole-integral machinery with solid ones.
    """
    ro2 = rho * om * om
    gam2 = k * k - (om / a) ** 2
    z = torch.zeros_like(ro2 * gam2)
    return _matrix([[z, -k, z, z],
                    [z, z, z, -gam2 / ro2],
                    [z, z, z, z],
                    [z, -ro2, z, z]])


def _psv_halfspace_basis(k, om, a, b, rho):
    """Decaying-downward P and SV displacement-stress eigenvectors,
    (..., 4) each: the exact null vectors of (A + g I) for the
    `_psv_system` matrix A, with (ur, uz) proportional to (k, ga) for P
    and (gb, k) for SV, szr = -mu (g ur + k uz), szz = k lam ur - g
    (lam + 2 mu) uz."""
    mu = rho * b * b
    c = om / k
    ga = k * torch.sqrt(torch.clamp(1.0 - (c / a) ** 2, min=1e-12))
    gb = k * torch.sqrt(torch.clamp(1.0 - (c / b) ** 2, min=1e-12))
    ksq = k * k
    ro2 = rho * om * om
    vP = torch.stack(torch.broadcast_tensors(
        k, ga, -2.0 * mu * k * ga, ro2 - 2.0 * mu * ksq), dim=-1)
    vS = torch.stack(torch.broadcast_tensors(
        gb, k, -mu * (gb * gb + ksq), -2.0 * mu * k * gb), dim=-1)
    return vP, vS


def _take(x, i):
    """x[k, i[k]] of a (K, L, ...) tensor for per-lane indices (K,)."""
    idx = i.long().reshape(-1, 1, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(-1, 1, *x.shape[2:]))[:, 0]


def _lanes(t, c0, ok, vp, vs, rho, qsinv, fac, cfg, nlay):
    """The (K, L) attenuated + flattened model of each lane, its
    truncation, safe root and wavenumber: (a, b, rho, d, mm, c, om, k)."""
    a_f, b_f, rho_f, d_f = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
    K, L = t.shape[0], vp.shape[-1]
    rho_f, d_f = rho_f.expand(K, L), d_f.expand(K, L)
    mm = effective_halfspace(c0, t, b_f, d_f, nlay, cfg.fact)
    c_safe = torch.where(ok, c0, b_f[:, 0] + 0.5)
    om = TWO_PI / t
    return a_f, b_f, rho_f, d_f, mm, c_safe, om, om / c_safe


def _lane_states(t, c0, ok, vp, vs, rho, fac, cfg, nlay, kind, qsinv):
    """Layer-top eigenfunction states + per-layer system matrices.

    All K = (period, mode) lanes at once: ``t``, ``c0``, ``ok`` are (K,).
    Returns ``(prof, Asys, hs)``: ``prof`` (K, L, ncmp) is the
    displacement-stress vector at every layer top, normalised to unit
    surface displacement (vertical for Rayleigh, transverse for Love);
    ``Asys`` (K, L, ncmp, ncmp) the first-order system matrix of each
    (flattened, attenuated) layer, so the eigenfunction *within* layer l
    at depth s below its top is ``expm(Asys[l] s) @ prof[l]``; ``hs``
    (K,) the index of the truncation halfspace.
    """
    a_f, b_f, rho_f, d_f, mm, c_safe, om, k = _lanes(
        t, c0, ok, vp, vs, rho, qsinv, fac, cfg, nlay)
    K, L = a_f.shape
    idx = torch.arange(L, device=a_f.device)
    hs = mm - 1
    active = idx < hs[:, None]                 # layers above the halfspace
    water = b_f.abs() <= 1e-8
    # leading (surface) water stack — the only place liquid is physical
    # (surfa.f:216-251, 876-911)
    wtop = torch.cumprod(water.to(torch.int32), dim=-1).bool()
    kk, oo = k[:, None], om[:, None]
    # every layer at or below a lane's halfspace propagates as the
    # identity: the loops stop at the deepest lane's halfspace
    n_up = int(hs.max())
    gate = (idx <= hs[:, None]) & ok[:, None]

    def expm_layers(A, act):
        d = torch.where(act, d_f, torch.zeros_like(d_f))
        return torch.linalg.matrix_exp(A * d[..., None, None])

    if kind == 2:
        b_solid = torch.where(water, torch.ones_like(b_f), b_f)
        Apsv = _psv_system(kk, oo, a_f, b_solid, rho_f)     # (K, L, 4, 4)
        Awat = _fluid_system4(kk, oo, a_f, rho_f)
        Asys = torch.where(water[..., None, None], Awat, Apsv)
        # upward propagator over layer l: expm(-A d); identity when the
        # layer is water, below the halfspace, or zero-thickness (water
        # couples through the impedance condition instead, as the
        # reference skips b <= 0 layers, surfa.f:1000)
        mats = expm_layers(-Asys, active & ~water)
        a_h, b_h, rho_h = (_take(x, hs) for x in (a_f, b_f, rho_f))
        vP0, vS0 = _psv_halfspace_basis(k, om, a_h, b_h, rho_h)

        # ---- water column: downward acoustic pass from the free surface
        # (szz = 0: state (0, 1, 0, 0)) through the leading water stack;
        # the carry at the end is the interface state, tzz = szz/uz there
        # the reference's water impedance (surfa.f:910)
        n_w = int(wtop.sum(-1).max())
        fmats = expm_layers(Asys, wtop)
        f = torch.zeros(K, 4, dtype=a_f.dtype, device=a_f.device)
        f[:, 1] = 1.0
        ftops = []
        for m in range(n_w):
            ftops.append(f)
            f = (fmats[:, m] @ f[..., None])[..., 0]
        uz_int = torch.where(f[:, 1].abs() > 1e-30, f[:, 1],
                             torch.ones_like(f[:, 1]))
        tzz = torch.where(wtop.any(-1), f[:, 3] / uz_int,
                          torch.zeros_like(f[:, 3]))

        # Stabilised two-solution shooting: QR re-orthonormalisation at
        # every layer top keeps the (P, SV) subspace exactly and both
        # columns O(1) (continuous orthonormalisation)
        Y = torch.stack([vP0, vS0], dim=-1)                  # (K, 4, 2)
        Y = Y / torch.linalg.vector_norm(Y, dim=-2, keepdim=True)
        Qs, Rs = [None] * (n_up + 1), [None] * n_up
        Qs[n_up] = Y
        for m in range(n_up - 1, -1, -1):
            Y, Rs[m] = torch.linalg.qr(mats[:, m] @ Y)
            Qs[m] = Y

        # boundary condition at the top of the SOLID stack (water
        # propagators are identity, so Qs[0] is the interface basis):
        # szr = 0 and szz = tzz uz; null vector via the adjugate row
        # with the larger norm
        Q0 = Qs[0]
        M11, M12 = Q0[:, 2, 0], Q0[:, 2, 1]
        M21 = Q0[:, 3, 0] - tzz * Q0[:, 1, 0]
        M22 = Q0[:, 3, 1] - tzz * Q0[:, 1, 1]
        a1 = torch.stack([M22, -M21], dim=-1)
        a2 = torch.stack([-M12, M11], dim=-1)
        use1 = (a1 * a1).sum(-1) >= (a2 * a2).sum(-1)
        cvec = torch.where(use1[:, None], a1, a2)

        # coefficients back down: c_l = R_l c_{l+1}
        prof = torch.zeros(K, L, 4, dtype=a_f.dtype, device=a_f.device)
        for m in range(n_up + 1):
            prof[:, m] = (Qs[m] @ cvec[..., None])[..., 0]
            if m < n_up:
                cvec = torch.linalg.solve_triangular(
                    Rs[m], cvec[..., None], upper=True)[..., 0]
        # unit uz at the top of the solid stack (surfa.f:1060-1066)
        norm = prof[:, 0, 1]
        norm = torch.where(norm.abs() > 0, norm, torch.ones_like(norm))
        prof = prof / norm[:, None, None]
        if n_w:
            # physical acoustic fields at the leading water layer tops,
            # at the same normalisation; the slaved ur = k szz/(rho
            # om^2) with each layer's own rho
            ft = torch.stack(ftops, dim=1) / uz_int[:, None, None]
            ur_w = kk * ft[..., 3] / (rho_f[:, :n_w] * oo * oo)
            ft = torch.cat([ur_w[..., None], ft[..., 1:]], dim=-1)
            top = torch.where(wtop[:, :n_w, None], ft, prof[:, :n_w])
            prof = torch.cat([top, prof[:, n_w:]], dim=1)
        prof = torch.where(gate[..., None], prof, torch.zeros_like(prof))
        return prof, Asys, hs          # columns: ur, uz, szr, szz

    # SH waves do not propagate in a fluid: water layers propagate as the
    # identity (the reference's b(m) <= 0 skips) and their rows are zero;
    # b -> 1 keeps the 1/mu entry finite
    b_sh = torch.where(water, torch.ones_like(b_f), b_f)
    Asys = _sh_system(kk, oo, b_sh, rho_f)                   # (K, L, 2, 2)
    mats = expm_layers(-Asys, active & ~water)
    bh = _take(b_f, hs)
    b_h = torch.where(bh.abs() > 1e-8, bh, torch.ones_like(bh))
    nu = k * torch.sqrt(torch.clamp(1.0 - (c_safe / b_h) ** 2, min=1e-12))
    mu_h = _take(rho_f, hs) * b_h * b_h
    v = torch.stack([torch.ones_like(k), -mu_h * nu], dim=-1)
    states = torch.zeros(K, L, 2, dtype=a_f.dtype, device=a_f.device)
    states[:, n_up] = v
    for m in range(n_up - 1, -1, -1):
        v = (mats[:, m] @ v[..., None])[..., 0]
        states[:, m] = v
    norm = states[:, 0, 0]
    norm = torch.where(norm.abs() > 0, norm, torch.ones_like(norm))
    prof = states / norm[:, None, None]
    keep = gate & ~wtop
    return (torch.where(keep[..., None], prof, torch.zeros_like(prof)),
            Asys, hs)                  # columns: ut, szt


def _prepare(h, periods, nlay, wave, cfg):
    """(periods, nlay, kind, FlatFactors, lane periods) for one model."""
    periods = torch.as_tensor(periods, dtype=h.dtype, device=h.device)
    nl = torch.as_tensor(nlay, device=h.device).reshape(())
    kind = 1 if wave in ("love", "lov", "L") else 2
    _, fac = model_preamble(h, nl, kind, cfg.flat)
    return periods, nl, kind, fac, periods.repeat_interleave(cfg.nmodes)


def eigenfunctions(h, vp, vs, rho, qsinv, periods, nlay,
                   wave: str = "rayleigh", cfg: SurfConfig = SurfConfig()):
    """Displacement/stress eigenfunctions at every layer top.

    Returns a dict with the dispersion results (``c``, ``u``, ``valid``
    of shape (P, nmodes)) plus depth profiles of shape (P, nmodes, L):

      Rayleigh: ``ur``, ``uz``, ``szr``, ``szz``  (uz(0) = 1)
      Love:     ``ut``, ``szt``                   (ut(0) = 1)

    ``z`` (L,) gives the flattened-domain depths of the layer tops;
    entries below each lane's truncation halfspace are zero.

    Water-topped models: the Rayleigh solid stack is solved against the
    water-column impedance (szz = tzz uz, szr = 0 at the interface,
    ``surfa.f:876-911``), normalised to unit uz at the water/solid
    interface (``surfa.f:1375-1379``), and the water layer tops carry the
    acoustic fields (szr = 0, ur slaved to szz).  Love rows inside water
    are zero.
    """
    c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods,
                                        nlay, wave=wave, cfg=cfg)
    periods, nl, kind, fac, t_l = _prepare(h, periods, nlay, wave, cfg)
    prof, _, _ = _lane_states(t_l, c_all.reshape(-1), ok_all.reshape(-1),
                              vp, vs, rho, fac, cfg, nl, kind, qsinv)
    P, L = periods.shape[0], h.shape[-1]
    prof = prof.reshape(P, cfg.nmodes, L, -1)
    out = {"c": c_all, "u": u_all, "valid": ok_all,
           "z": torch.cumsum(fac.h_flat, dim=-1) - fac.h_flat}
    if kind == 2:
        out.update(ur=prof[..., 0], uz=prof[..., 1], szr=prof[..., 2],
                   szz=prof[..., 3])
    else:
        out.update(ut=prof[..., 0], szt=prof[..., 1])
    return out


def _exp_pair_integral(coA, coB, p, q):
    """∫_0^∞ f g ds for f = coA·(e^{-ps}, e^{-qs}), g = coB·(...), with
    the coefficient pairs on the last axis: the closed form of the
    halfspace tail integrals (``surfa.f:618-620`` Love,
    ``surfa.f:1303-1308`` Rayleigh)."""
    return (coA[..., 0] * coB[..., 0] / (2.0 * p)
            + (coA[..., 0] * coB[..., 1] + coA[..., 1] * coB[..., 0])
            / (p + q)
            + coA[..., 1] * coB[..., 1] / (2.0 * q))


def _halfspace_tail(prof, a_f, b_f, rho_f, hs, c_safe, om, k):
    """The Rayleigh halfspace state of each lane as a combination of the
    decaying P and SV solutions: (V (K, 4, 2), coefficients (K, 2), the
    rates (ga, gb))."""
    a_h, b_h, rho_h = (_take(x, hs) for x in (a_f, b_f, rho_f))
    vP0, vS0 = _psv_halfspace_basis(k, om, a_h, b_h, rho_h)
    V = torch.stack([vP0, vS0], dim=-1)
    G = V.transpose(-1, -2) @ V
    eye = torch.eye(2, dtype=V.dtype, device=V.device)
    rhs = V.transpose(-1, -2) @ _take(prof, hs)[..., None]
    coef = torch.linalg.solve(G + 1e-30 * eye, rhs)[..., 0]
    ga = k * torch.sqrt(torch.clamp(1.0 - (c_safe / a_h) ** 2, min=1e-12))
    gb = k * torch.sqrt(torch.clamp(1.0 - (c_safe / b_h) ** 2, min=1e-12))
    return V, coef, ga, gb


def energy_integrals(h, vp, vs, rho, qsinv, periods, nlay,
                     wave: str = "rayleigh", cfg: SurfConfig = SurfConfig(),
                     npanel: int = 8, c_given=None):
    """Eigenfunction energy integrals + the integral-path group velocity.

    The reference's second group-velocity implementation (LEIGEN/REIGEN):

      Love      (``surfa.f:712-716``):
        I0 = ∫ ρ ut²,  I1 = ∫ μ ut²,  I2 = ∫ μ ut'²
        u  = I1 / (c I0),  flagr = ω² I0 - k² I1 - I2,
        variational k² = (ω² I0 - I2) / I1
      Rayleigh  (``surfa.f:1270-1273, 1333-1338``):
        I0 = ∫ ρ (ur² + uz²),   I1 = ∫ (λ+2μ) ur² + μ uz²
        I2 = ∫ μ uz ur' - λ ur uz',  I3 = ∫ (λ+2μ) uz'² + μ ur'²
        u  = (k I1 + I2) / (ω I0),  flagr = ω² I0 - k² I1 - 2k I2 - I3
        variational k = (-I2 + sqrt(I2² - I1 (I3 - ω² I0))) / I1

    Fields at 4·npanel+1 nodes per layer, ``expm(A s) @ prof`` on the
    layer-top states (composite Boole weights, the reference's 5-point
    rule per sublayer), plus the analytic halfspace tail; all in the
    attenuated + flattened domain, normalised to unit surface
    displacement (``surfa.f:709-711``).  A surface water column
    contributes to the Rayleigh integrals through its acoustic fields;
    the water-only partials come back as ``I0_wat``..``I3_wat``.

    Returns a dict of (P, nmodes) tensors: ``c``, ``u`` (implicit-diff),
    ``valid``, ``I0``, ``I1``, ``I2``, ``I3`` + ``I*_wat`` (Rayleigh
    only), ``flagr``, ``u_int``, ``c_var``.

    ``c_given``: evaluate at externally supplied roots (P, nmodes); the
    dispersion solver is then skipped and ``u`` comes back as zeros.
    """
    if c_given is not None:
        P = torch.as_tensor(periods).shape[0]
        c_all = torch.as_tensor(c_given, dtype=h.dtype,
                                device=h.device).reshape(P, cfg.nmodes)
        ok_all = c_all > 0.0
        u_all = torch.zeros_like(c_all)
    else:
        c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods,
                                            nlay, wave=wave, cfg=cfg)
    periods, nl, kind, fac, t_l = _prepare(h, periods, nlay, wave, cfg)
    c0, ok = c_all.reshape(-1), ok_all.reshape(-1)
    prof, Asys, hs = _lane_states(t_l, c0, ok, vp, vs, rho, fac, cfg, nl,
                                  kind, qsinv)
    a_f, b_f, rho_f, d_f, _, c_safe, om, k = _lanes(
        t_l, c0, ok, vp, vs, rho, qsinv, fac, cfg, nl)
    K, L = a_f.shape
    dtype, device = a_f.dtype, a_f.device
    mu = rho_f * b_f * b_f
    lam = rho_f * a_f * a_f - 2.0 * mu
    idx = torch.arange(L, device=device)
    water = b_f.abs() <= 1e-8
    wtop = torch.cumprod(water.to(torch.int32), dim=-1).bool()
    solid = (idx < hs[:, None]) & ~water
    # Rayleigh carries energy in the surface water column too; Love has
    # no fluid motion
    contrib = (solid | wtop) if kind == 2 else solid

    # composite-Boole node offsets (fractions of the layer thickness) and
    # weights: npanel panels x 5 nodes, endpoints shared
    nn = 4 * npanel + 1
    frac = torch.arange(nn, dtype=dtype, device=device) / (nn - 1.0)
    boole = torch.tensor([7.0, 32.0, 12.0, 32.0, 7.0], dtype=dtype,
                         device=device) / 22.5
    wts = torch.zeros(nn, dtype=dtype, device=device)
    for p_ in range(npanel):
        wts[4 * p_: 4 * p_ + 5] += boole / (4.0 * npanel)

    # fields at every node of every layer of every lane, over the layers
    # above the deepest lane's halfspace (the rest contribute nothing)
    n_up = int(hs.max())
    d = torch.where(contrib, d_f, torch.zeros_like(d_f))[:, :n_up]
    A = Asys[:, :n_up]
    s = frac * d[..., None]                                 # (K, n, nn)
    E = torch.linalg.matrix_exp(A[:, :, None] * s[..., None, None])
    w = (E @ prof[:, :n_up, None, :, None])[..., 0]         # (K, n, nn, c)
    dw = (A[:, :, None] @ w[..., None])[..., 0]
    wl = wts * d[..., None]
    sl = slice(0, n_up)
    if kind == 2:
        ur, uz, dur, duz = w[..., 0], w[..., 1], dw[..., 0], dw[..., 1]
        lm, m_ = lam[:, sl, None], mu[:, sl, None]
        per_layer = torch.stack([
            rho_f[:, sl] * (wl * (ur * ur + uz * uz)).sum(-1),
            (wl * ((lm + 2 * m_) * ur * ur + m_ * uz * uz)).sum(-1),
            (wl * (m_ * uz * dur - lm * ur * duz)).sum(-1),
            (wl * ((lm + 2 * m_) * duz * duz + m_ * dur * dur)).sum(-1)],
            dim=-1)                                          # (K, n, 4)
    else:
        ut, dut = w[..., 0], dw[..., 0]
        per_layer = torch.stack([
            rho_f[:, sl] * (wl * ut * ut).sum(-1),
            mu[:, sl] * (wl * ut * ut).sum(-1),
            mu[:, sl] * (wl * dut * dut).sum(-1)], dim=-1)
    ints = per_layer.sum(1)
    ints_wat = torch.where(wtop[:, sl, None], per_layer,
                           torch.zeros_like(per_layer)).sum(1)

    # ---- analytic halfspace tail -----------------------------------------
    lam_h, mu_h, rho_h = (_take(x, hs) for x in (lam, mu, rho_f))
    zero = torch.zeros_like(c_safe)
    if kind == 2:
        V, coef, ga, gb = _halfspace_tail(prof, a_f, b_f, rho_f, hs, c_safe,
                                          om, k)
        cur = coef * V[:, 0]     # ur = cur·(e^{-ga s}, e^{-gb s})
        cuz = coef * V[:, 1]
        rates = torch.stack([ga, gb], dim=-1)
        cdur, cduz = -rates * cur, -rates * cuz

        def E2(x, y):
            return _exp_pair_integral(x, y, ga, gb)

        tail = torch.stack([
            rho_h * (E2(cur, cur) + E2(cuz, cuz)),
            (lam_h + 2 * mu_h) * E2(cur, cur) + mu_h * E2(cuz, cuz),
            mu_h * E2(cuz, cdur) - lam_h * E2(cur, cduz),
            (lam_h + 2 * mu_h) * E2(cduz, cduz) + mu_h * E2(cdur, cdur)],
            dim=-1)
        I0, I1, I2, I3 = (ints + tail).unbind(-1)
        # our A&R system carries the opposite relative sign between (ur,
        # szr) and (uz, szz) to the reference's REIGEN fields (surfa.f:1241
        # uses durdz = atr/mu - wvno*auz), so the cross-term integral I2
        # flips sign; flip to the reference convention, in which u = (k I1
        # + I2)/(omega I0) reproduces the implicit-diff group velocity
        I2 = -I2
        u_int = (k * I1 + I2) / (om * I0)
        flagr = om * om * I0 - k * k * I1 - 2.0 * k * I2 - I3
        disc = I2 * I2 - I1 * (I3 - om * om * I0)
        k_var = (-I2 + torch.sqrt(disc.abs())) / I1
        outs = torch.stack([I0, I1, I2, I3, flagr, u_int, om / k_var,
                            ints_wat[:, 0], ints_wat[:, 1], -ints_wat[:, 2],
                            ints_wat[:, 3]], dim=-1)
    else:
        bh = _take(b_f, hs)
        b_h = torch.where(bh.abs() > 1e-8, bh, torch.ones_like(bh))
        nu = k * torch.sqrt(torch.clamp(1.0 - (c_safe / b_h) ** 2,
                                        min=1e-12))
        ut_h = _take(prof, hs)[:, 0]
        I0 = ints[:, 0] + rho_h * ut_h * ut_h / (2.0 * nu)
        I1 = ints[:, 1] + mu_h * ut_h * ut_h / (2.0 * nu)
        I2 = ints[:, 2] + mu_h * ut_h * ut_h * nu / 2.0
        u_int = I1 / (c_safe * I0)
        flagr = om * om * I0 - k * k * I1 - I2
        k_var = torch.sqrt((om * om * I0 - I2).abs() / I1)
        outs = torch.stack([I0, I1, I2, zero, flagr, u_int, om / k_var,
                            zero, zero, zero, zero], dim=-1)

    P = periods.shape[0]
    outs = outs.reshape(P, cfg.nmodes, 11)
    res = {"c": c_all, "u": u_all, "valid": ok_all,
           "I0": outs[..., 0], "I1": outs[..., 1], "I2": outs[..., 2],
           "flagr": outs[..., 4], "u_int": outs[..., 5],
           "c_var": outs[..., 6]}
    if kind == 2:
        res["I3"] = outs[..., 3]
        res.update(I0_wat=outs[..., 7], I1_wat=outs[..., 8],
                   I2_wat=outs[..., 9], I3_wat=outs[..., 10])
    return res


def eigenfunctions_regular(h, vp, vs, rho, qsinv, periods, nlay,
                           wave: str = "rayleigh",
                           cfg: SurfConfig = SurfConfig(),
                           dz: float = 2.0, nz: int = 300, c_given=None):
    """Eigenfunctions on a regular *spherical* depth grid.

    The SURF_PERTURB ``-s dz`` capability: rows ``z, v*(1-z/R0), v' -
    v/R0`` of spherical depth, flattening-corrected displacement and its
    spherical-depth derivative (``calcul_deep.f:293-296, 381-393``,
    KEY_FLAT branch), each sample ``expm(Asys s) @ prof`` within its
    layer, and below the truncation halfspace the decaying tail
    (``surfa.f:748-830``).

    Returns a dict of (P, nmodes, nz) tensors in the reference's printed
    convention (surface vertical/transverse displacement = 1):

      Rayleigh: ``v1``/``dv1`` (horizontal), ``v2``/``dv2`` (vertical)
      Love:     ``v1``/``dv1`` (transverse)

    plus ``z`` (nz,) spherical depths, ``mask`` (P, nmodes, nz) True
    where the lane was solved, ``in_water`` (nz,) True inside a surface
    water column (the reference prints zeros there, ``surfa.f:1375,
    1400``), and the dispersion outputs ``c``, ``u``, ``valid``.  The
    horizontal component follows the A&R sign, which may be globally
    flipped per profile against the reference's.

    ``c_given`` (P, nmodes), optional: evaluate at these phase
    velocities instead of the roots; the solve still runs and its ``u``
    is kept.
    """
    c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods,
                                        nlay, wave=wave, cfg=cfg)
    if c_given is not None:
        c_all = torch.as_tensor(c_given, dtype=h.dtype,
                                device=h.device).reshape(c_all.shape)
        ok_all = c_all > 0.0
    periods, nl, kind, fac, t_l = _prepare(h, periods, nlay, wave, cfg)
    dtype, device = h.dtype, h.device
    L = h.shape[-1]

    z_s = torch.arange(nz, dtype=dtype, device=device) * dz
    if cfg.flat:
        # tensor / tensor: a scalar numerator would round through the
        # reciprocal, and samples exactly at a layer top (the water/solid
        # interface) must tie with ``z_tops`` as in the flattening
        r0 = torch.full_like(z_s, R0_KM)
        z_f = R0_KM * torch.log(r0 / (r0 - z_s))
        amp_fac = 1.0 - z_s / R0_KM
    else:
        z_f, amp_fac = z_s, torch.ones_like(z_s)
    z_tops = torch.cumsum(fac.h_flat, dim=-1) - fac.h_flat
    wtop0 = torch.cumprod((vs.abs() <= 1e-8).to(torch.int32), dim=-1).bool()
    z_int = torch.where(wtop0, fac.h_flat, torch.zeros_like(fac.h_flat)).sum()
    in_water = z_f < z_int - 1e-9
    lay = torch.clamp(torch.searchsorted(z_tops.contiguous(), z_f.contiguous(),
                                         right=True) - 1, 0, L - 1)

    c0, ok = c_all.reshape(-1), ok_all.reshape(-1)
    prof, Asys, hs = _lane_states(t_l, c0, ok, vp, vs, rho, fac, cfg, nl,
                                  kind, qsinv)
    K = t_l.shape[0]
    z_hs = z_tops[hs]                                       # (K,)
    below = z_f > z_hs[:, None]                              # (K, nz)
    s = torch.where(below, torch.zeros_like(below, dtype=dtype),
                    z_f - z_tops[lay])                       # no expm overflow
    A = Asys[:, lay]                                         # (K, nz, n, n)
    w = (torch.linalg.matrix_exp(A * s[..., None, None])
         @ prof[:, lay, :, None])[..., 0]
    dw = (A @ w[..., None])[..., 0]

    # below the truncation halfspace the solution continues as the pure
    # decaying combination (surfa.f:748-830, halfspace branch)
    a_f, b_f, rho_f, _, _, c_safe, om, k = _lanes(
        t_l, c0, ok, vp, vs, rho, qsinv, fac, cfg, nl)
    s_hs = torch.clamp(z_f - z_hs[:, None], min=0.0)         # (K, nz)
    if kind == 2:
        V, coef, ga, gb = _halfspace_tail(prof, a_f, b_f, rho_f, hs, c_safe,
                                          om, k)
        decay = torch.exp(-torch.stack([ga, gb], dim=-1)[:, None, :]
                          * s_hs[..., None])                 # (K, nz, 2)
        w_ext = (coef[:, None, :] * decay) @ V.transpose(-1, -2)
    else:
        bh = _take(b_f, hs)
        b_h = torch.where(bh.abs() > 1e-8, bh, torch.ones_like(bh))
        nu = k * torch.sqrt(torch.clamp(1.0 - (c_safe / b_h) ** 2,
                                        min=1e-12))
        w_ext = (_take(prof, hs)[:, None, :]
                 * torch.exp(-nu[:, None] * s_hs)[..., None])
    dw_ext = w_ext @ _take(Asys, hs).transpose(-1, -2)
    w = torch.where(below[..., None], w_ext, w)
    dw = torch.where(below[..., None], dw_ext, dw)
    valid = ok[:, None].expand(K, nz)
    w = torch.where(valid[..., None], w, torch.zeros_like(w))
    dw = torch.where(valid[..., None], dw, torch.zeros_like(dw))

    P = periods.shape[0]
    w = w.reshape(P, cfg.nmodes, nz, -1)
    dw = dw.reshape(P, cfg.nmodes, nz, -1)
    out = {"c": c_all, "u": u_all, "valid": ok_all, "z": z_s,
           "mask": valid.reshape(P, cfg.nmodes, nz), "in_water": in_water}
    deriv_corr = (1.0 / R0_KM) if cfg.flat else 0.0
    out["v1"] = w[..., 0] * amp_fac
    out["dv1"] = dw[..., 0] - w[..., 0] * deriv_corr
    if kind == 2:
        out["v2"] = w[..., 1] * amp_fac
        out["dv2"] = dw[..., 1] - w[..., 1] * deriv_corr
    return out

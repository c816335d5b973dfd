"""Depth sensitivity kernels and apparent Q via implicit differentiation.

Counterpart of the JAX package's ``ops/kernels.py``, which replaces the
reference's two kernel pipelines (senskernel-1.0 PHV_SENS_KERNEL,
``PHV_SENS_KERNEL.f:168-182``, and SensKernelPert's +-0.1 % finite
differences) with one reverse-mode AD pass: at a root ``F(c*, T; m) = 0``
of the secular function the implicit function theorem gives

    dc/dm = - (dF/dm) / (dF/dc),

so one gradient of F evaluates every layer's dc/dVs, dc/dVp, dc/drho at
once.  Group-velocity kernels follow from differentiating u(m) = c/(1 -
(T/c) F_T/F_c) (nested AD, replacing GRV_SENS_KERNEL's dlnT finite
difference, ``GRV_SENS_KERNEL.f:100-108``), and apparent Q from the
derivatives with respect to the attenuated + flattened model
(``calcul.f:256-265, 341-349``):

    Rayleigh: skd = sum_i (dc/da_i * 4/3 (b_i/a_i) + dc/db_i) b_i qsinv_i
    Love:     skd = sum_i dc/db_i b_i qsinv_i
    Q_app    = c^2 / (skd * u)

The JAX code vmaps ``jax.grad`` over the (period, mode) lanes.  Here each
lane carries its own copy of the model as a (K, L) leaf tensor, so one
``torch.autograd.grad`` of the summed secular values gives every lane's
gradient at once (the lanes are independent).  The secular functions are
the single-model solve's eager ones (:mod:`pysurfinv_tpu_torch.ops.secular`),
whose detached renormalisation is the AD convention of JAX's
``stop_gradient``; they run in the inputs' dtype on their device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _secular_fn,
                                                surf_forward)
from pysurfinv_tpu_torch.ops.flatten import (FlatFactors, effective_thickness,
                                             flatten_factors)
from pysurfinv_tpu_torch.ops.secular import (attenuation_rescale,
                                             effective_halfspace)


class KernelResult(NamedTuple):
    c: torch.Tensor        # (P,) phase velocity, fundamental mode
    u: torch.Tensor        # (P,) group velocity
    valid: torch.Tensor    # (P,) bool
    dc_dvs: torch.Tensor   # (P, L) layer-integrated phase kernels
    dc_dvp: torch.Tensor   # (P, L)
    dc_drho: torch.Tensor  # (P, L)
    dc_dh: torch.Tensor    # (P, L) w.r.t. layer thickness
    du_dvs: torch.Tensor   # (P, L) group kernels (zeros unless group=True)
    du_dvp: torch.Tensor   # (P, L)
    du_drho: torch.Tensor  # (P, L)
    q_app: torch.Tensor    # (P,) apparent quality factor


def _flat_model(t, vp, vs, rho, h_eff, qsinv, nlay, kind, cfg):
    """(a, b, rho, d) attenuated+flattened — differentiable in all inputs.
    ``t`` (K,) against (K, L) or (L,) model arrays."""
    if cfg.flat:
        fac = flatten_factors(h_eff, nlay, kind)
    else:
        ones = torch.ones_like(h_eff)
        fac = FlatFactors(h_flat=h_eff, vel_fac=ones, rho_fac=ones)
    if cfg.atten:
        a_t, b_t = attenuation_rescale(vp, vs, qsinv, t[..., None],
                                       cfg.t_base)
    else:
        a_t, b_t = vp, vs
    return (a_t * fac.vel_fac, b_t * fac.vel_fac, rho * fac.rho_fac,
            fac.h_flat)


def _nonzero(x):
    return torch.where(x.abs() > 0, x, torch.ones_like(x))


def sensitivity_kernels(h, vp, vs, rho, qsinv, periods, nlay,
                        wave: str = "rayleigh",
                        cfg: SurfConfig = SurfConfig(),
                        group: bool = True) -> KernelResult:
    """Phase/group kernels and apparent Q for one padded model.

    All derivatives are with respect to the *input* (spherical,
    unattenuated) layer properties — what SensKernelPert measures by
    finite differences — including the chain through the physical-
    dispersion rescale and the earth-flattening transform.  ``nmodes >
    1`` adds a mode axis: (P, nmodes, L) kernels, (P, nmodes) scalars.
    Runs in the inputs' dtype on their device; returns tensors there.
    """
    h, vp, vs, rho, qsinv = (x.detach() for x in (h, vp, vs, rho, qsinv))
    dtype, device = h.dtype, h.device
    nmodes = cfg.nmodes
    c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                                        wave=wave, cfg=cfg)
    periods = torch.as_tensor(periods, dtype=dtype, device=device)
    nl = torch.as_tensor(nlay, device=device).reshape(())
    P, L = periods.shape[0], h.shape[-1]
    # every (period, mode) pair is one lane of one batched pass
    t = periods.repeat_interleave(nmodes)
    c0, ok = c_all.reshape(-1), ok_all.reshape(-1)
    K = t.shape[0]

    kind = 1 if wave in ("love", "lov", "L") else 2
    F = _secular_fn(wave)
    h_eff = effective_thickness(h, nl)

    def leaf(x):
        """A (K, L) copy of a model array: one independent leaf a lane."""
        return x.expand(K, L).clone().requires_grad_(True)

    with torch.no_grad():
        mdl0 = _flat_model(t, vp, vs, rho, h_eff, qsinv, nl, kind, cfg)
        mdl0 = tuple(x.expand(K, L) for x in mdl0)
        mm = effective_halfspace(c0, t, mdl0[1], mdl0[3], nl, cfg.fact)
        c_safe = torch.where(ok, c0, mdl0[1][:, 0] + 0.5)

    with torch.enable_grad():
        # --- phase kernels: one reverse pass ----------------------------
        c_ = c_safe.clone().requires_grad_(True)
        vp_, vs_, rho_, h_ = (leaf(x) for x in (vp, vs, rho, h_eff))
        mdl = _flat_model(t, vp_, vs_, rho_, h_, qsinv, nl, kind, cfg)
        f_c, f_vp, f_vs, f_rho, f_h = torch.autograd.grad(
            F(c_, t, mdl, mm).sum(), (c_, vp_, vs_, rho_, h_),
            materialize_grads=True)
        f_c = _nonzero(f_c)[:, None]
        dc_dvp, dc_dvs = -f_vp / f_c, -f_vs / f_c
        dc_drho, dc_dh = -f_rho / f_c, -f_h / f_c

        # --- apparent Q (calcul.f:256-265, 341-349) ----------------------
        c_ = c_safe.clone().requires_grad_(True)
        a_f, b_f = (x.clone().requires_grad_(True) for x in mdl0[:2])
        g_c, g_a, g_b = torch.autograd.grad(
            F(c_, t, (a_f, b_f, mdl0[2], mdl0[3]), mm).sum(), (c_, a_f, b_f),
            materialize_grads=True)
        g_c = _nonzero(g_c)[:, None]
        dcda_f, dcdb_f = -g_a / g_c, -g_b / g_c
        a_safe = _nonzero(mdl0[0])
        if kind == 2:
            dwx = (dcda_f * 1.33333333 * mdl0[1] / a_safe + dcdb_f) * mdl0[1]
        else:
            dwx = dcdb_f * mdl0[1]
        active = torch.arange(L, device=device) < nl
        skd = torch.where(active, dwx * qsinv, torch.zeros_like(dwx)).sum(-1)

        # --- group velocity + kernels ------------------------------------
        # u(m) = W(c*(m), m); du/dm = W_m + W_c dc/dm with dc/dm from the
        # implicit function theorem — nested AD, no custom rules.  F_T is
        # the partial at fixed material: the outer t goes into the model,
        # only tt into F (the reference's group velocity convention)
        c_ = c_safe.clone().requires_grad_(True)
        vp_, vs_, rho_ = (leaf(x) for x in (vp, vs, rho))
        tt = t.clone().requires_grad_(True)
        mdl = _flat_model(t, vp_, vs_, rho_, h_eff, qsinv, nl, kind, cfg)
        f_cc, f_tt = torch.autograd.grad(F(c_, tt, mdl, mm).sum(), (c_, tt),
                                         create_graph=group)
        W = c_ / (1.0 - (t / c_) * f_tt / _nonzero(f_cc))
        if group:
            W_c, W_vp, W_vs, W_rho = torch.autograd.grad(
                W.sum(), (c_, vp_, vs_, rho_), materialize_grads=True)
            W_c = W_c[:, None]
            du_dvp = W_vp + W_c * dc_dvp
            du_dvs = W_vs + W_c * dc_dvs
            du_drho = W_rho + W_c * dc_drho
        else:
            du_dvp = du_dvs = du_drho = torch.zeros(K, L, dtype=dtype,
                                                    device=device)
        u0 = W.detach()

    q_app = c_safe * c_safe / (skd.detach() * u0)
    zero = torch.zeros((), dtype=dtype, device=device)

    def shape(x, per_layer=True):
        x = x.detach()
        if per_layer:
            x = torch.where(ok[:, None], x, zero)
            return x if nmodes == 1 else x.reshape(P, nmodes, -1)
        return x if nmodes == 1 else x.reshape(P, nmodes)

    return KernelResult(
        c=shape(c0, False), u=shape(torch.where(ok, u0, zero), False),
        valid=shape(ok, False),
        dc_dvs=shape(dc_dvs), dc_dvp=shape(dc_dvp), dc_drho=shape(dc_drho),
        dc_dh=shape(dc_dh), du_dvs=shape(du_dvs), du_dvp=shape(du_dvp),
        du_drho=shape(du_drho),
        q_app=shape(torch.where(ok, q_app, zero), False),
    )


def _np(x):
    """A tensor (any device) or array as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def kernel_densities(h, vp, vs, rho, qsinv, periods, nlay,
                     wave: str = "rayleigh",
                     cfg: SurfConfig = SurfConfig(),
                     dz: float = 2.0, nz: int = 300,
                     group: bool = False, c_given=None):
    """Reference-convention Fréchet DENSITIES on a regular depth grid.

    The reference's kernel product: normalized sensitivities per km,
    sampled every ``dz`` km, assembled from eigenfunctions by the
    variational formulas of ``PHV_SENS_KERNEL.f:168-182``:

      Rayleigh:
        dc/db = b rho / (u I0) ((V1 + V2'/k)^2 + (4/k) V1' V2)
        dc/da = a rho / (u I0) (V2 - V1'/k)^2
        dc/drh = (dc/da a + dc/db b)/(2 rho) - c^2 (V1^2+V2^2)/(2 u I0)
      Love:
        dc/db = b rho / (u I0) (V3^2 + (V3'/k)^2)
        dc/drh = dc/db b / (2 rho) - c^2 V3^2 / (2 u I0)

    written as ``(dc/dm) m / c``; the group densities combine three such
    runs at T*{0.99, 1, 1.01} by the two-sided dlnT difference of
    ``GRV_SENS_KERNEL.f:100-108``, written ``(du/dm) m / u``.  As in the
    JAX package, the material lookups use the INPUT (spherical) model's
    layer table at the output depths (``PHV_SENS_KERNEL.f:150-160``), and
    the group Rho density uses the sign-correct "-" dlnT term (the
    reference flips it for Rho only, ``GRV_SENS_KERNEL.f:107``).

    The eigenfunctions and energy integrals run on the inputs' device;
    the assembly is numpy.  Returns a dict of numpy (P, nmodes, nz)
    arrays ``Kvs``, ``Kvp`` (R only), ``Krho`` (and ``Gvs``/``Gvp``/
    ``Grho`` when ``group=True``), plus ``z`` (nz,), ``c``, ``u``
    (integral-path), ``valid``.  Rows inside a surface water column are
    zero.  ``c_given`` (P, nmodes): evaluate at supplied roots.
    """
    from pysurfinv_tpu_torch.ops.eigen import (eigenfunctions_regular,
                                               energy_integrals)

    kind = 1 if wave in ("love", "lov", "L") else 2

    def one_run(pers, cg):
        reg = eigenfunctions_regular(h, vp, vs, rho, qsinv, pers, nlay,
                                     wave=wave, cfg=cfg, dz=dz, nz=nz,
                                     c_given=cg)
        ei = energy_integrals(h, vp, vs, rho, qsinv, pers, nlay,
                              wave=wave, cfg=cfg, c_given=reg["c"])
        return reg, ei

    # spherical-model step lookup at the output depths (verbatim border
    # convention: value of the layer whose [border, border) interval
    # contains z; beyond the last border, the halfspace row)
    nlay = int(nlay)
    h_np = _np(h)[:nlay]
    borders = np.concatenate([[0.0], np.cumsum(h_np)])
    z = np.arange(nz) * dz
    lay = np.clip(np.searchsorted(borders[1:-1], z, side="right"),
                  0, nlay - 1)
    a_z = _np(vp)[lay]
    b_z = _np(vs)[lay]
    rho_z = _np(rho)[lay]

    def densities(reg, ei, pers_run):
        c = _np(reg["c"])[..., None]            # (P, nmodes, 1)
        u = _np(ei["u_int"])[..., None]
        I0 = _np(ei["I0"])[..., None]
        # k = omega / c with omega = 2 pi / T of THIS run
        pers_b = _np(pers_run).astype(float)[:, None, None]
        wvn = 2.0 * np.pi / (c * pers_b)
        # PHV_SENS_KERNEL's V1 is the vertical and V2 the horizontal
        # eigenfunction (PHV_SENS_KERNEL.f:104-118); our A&R horizontal
        # component carries the opposite sign to the reference fields:
        # V2_ref = -v1_ours, V1_ref = v2_ours
        if kind == 2:
            V1 = _np(reg["v2"])       # vertical
            dV1 = _np(reg["dv2"])
            V2 = -_np(reg["v1"])      # horizontal, ref sign
            dV2 = -_np(reg["dv1"])
            dcdb = b_z * rho_z / (u * I0) * (
                (V1 + dV2 / wvn) ** 2 + 4.0 / wvn * dV1 * V2)
            dcda = a_z * rho_z / (u * I0) * (V2 - dV1 / wvn) ** 2
            dcdrh = (0.5 / rho_z * (dcda * a_z + dcdb * b_z)
                     - c ** 2 / (2.0 * u * I0) * (V1 ** 2 + V2 ** 2))
            out = {"Kvs": dcdb * b_z / c, "Kvp": dcda * a_z / c,
                   "Krho": dcdrh * rho_z / c}
        else:
            V3 = _np(reg["v1"])
            dV3 = _np(reg["dv1"])
            dcdb = b_z * rho_z / (u * I0) * (V3 ** 2 + (dV3 / wvn) ** 2)
            dcdrh = (0.5 / rho_z * dcdb * b_z
                     - 0.5 * c ** 2 / (u * I0) * V3 ** 2)
            out = {"Kvs": dcdb * b_z / c, "Krho": dcdrh * rho_z / c}
        inw = _np(reg["in_water"])
        for k in out:
            out[k] = np.where(inw[None, None, :], 0.0, out[k])
        return out, _np(reg["c"]), _np(ei["u_int"])

    pers = torch.as_tensor(_np(periods).astype(float), dtype=h.dtype,
                           device=h.device)
    reg0, ei0 = one_run(pers, c_given)
    K0, c0, u0 = densities(reg0, ei0, pers)
    res = dict(K0)
    res.update(z=z, c=c0, u=u0, valid=_np(reg0["valid"]))

    if group:
        Km, cm, _ = densities(*one_run(pers * 0.99, None), pers * 0.99)
        Kp, cp, _ = densities(*one_run(pers * 1.01, None), pers * 1.01)
        dom = float(np.log(1.01))
        u_c = (u0 / c0)[..., None]
        for name in K0:
            # de-normalise to (dc/dm) m, combine, re-normalise by u
            kp = Kp[name] * cp[..., None]
            km = Km[name] * cm[..., None]
            avg = 0.5 * u_c * (2.0 - u_c) * (kp + km)
            dif = 0.5 * u_c ** 2 * (kp - km) / dom
            res["G" + name[1:]] = (avg - dif) / u0[..., None]
    return res

"""Thermal models and temperature -> (Vs, Qs) conversions, in PyTorch.

Capability spec from the reference pySurfInv's ``ThermSeis.py``: 1-D
oceanic mantle temperature/pressure/density profiles (half-space
cooling with an adiabat onset) and the temperature -> seismic
conversions (the first two are the ones the Cascadia ocean stack uses,
``models/layers.py`` ``OceanMantleHybrid``):

  * OceanSeisRitz  — Voigt-Reuss-Hill over 5 minerals (Ritzwoller 2004)
  * OceanSeisRuan  — Yamauchi & Takei 2016 anelasticity, Ruan 2018 solidus
  * OceanSeisYaTa  — Yamauchi & Takei 2016 (selectable solidus), and its
    unrelaxed-modulus and archival Ruan 2018 variants
  * OceanSeisJack  — Jackson & Faul 2010 (fixed-node log-Gauss quadrature)
  * OceanSeisPM13, OceanSeisBass, OceanSeisStix, behn2009_shear

Every function takes and returns tensors; the dtype and device are the
inputs'.  The adiabat-onset bisection runs the reference's fixed 16
iterations, so the result does not depend on data-dependent control
flow.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pysurfinv_tpu_torch.utils import device_constant

C2K = 273.15
SEC_PER_YEAR = 365 * 24 * 3600.0


def _t(x, like=None):
    """``x`` as a floating tensor (float64 unless ``like`` says otherwise)."""
    if torch.is_tensor(x):
        return x if x.is_floating_point() else x.double()
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float64)


# --------------------------------------------------------------------------
# Thermal structure
# --------------------------------------------------------------------------

def pressure(zdeps_km, rho=3.4e3):
    """P = rho g z (ThermSeis.py:22-27), in Pa."""
    return rho * 9.8 * zdeps_km * 1000.0


def thermal_density(P, T, rho0=3.43e3, P0=0.6e9, T0=500 + C2K,
                    alpha=4.4e-5, kappa=6.12e-12):
    """rho(P, T) (ThermSeis.py:30-35), in kg/m^3."""
    return rho0 * (1 - alpha * (T - T0)) * (1 + kappa * (P - P0))


def hscm_temperature(age_ma, zdeps_km, Tp=1325.0, kappa=1e-6):
    """Half-space-cooling temperature profile in K (ThermSeis.py:56-101).

    The mantle temperature Tm and the adiabat-onset depth are found by
    the reference's bisection (g(z) = f/f' - z - (Tp-T0)/Da on
    [0, 400] km), run for its exact 16 iterations.
    """
    age_ma = _t(age_ma)
    zdeps_km = _t(zdeps_km, like=age_ma)
    T0, Da = 0.0, 0.4
    diff_scale = 2.0 * torch.sqrt(age_ma * SEC_PER_YEAR * (kappa / 1e-6))

    def f(z):
        return torch.erf(z * 1e3 / diff_scale)

    def g(z):
        dz = 0.001
        fz = f(z)
        dfz = (f(z + dz) - fz) / dz + 1e-10
        return fz / dfz - z - (Tp - T0) / Da

    z0 = torch.zeros_like(age_ma)
    z1 = torch.full_like(age_ma, 400.0)
    for _ in range(16):
        z2 = 0.5 * (z0 + z1)
        neg = g(z2) < 0
        z0, z1 = torch.where(neg, z2, z0), torch.where(neg, z1, z2)
    Tm = (Da * z1 + Tp - T0) / f(z1) + T0
    z_adia = z0

    theta = torch.erf(zdeps_km * 1e3 / diff_scale)
    T = (Tm - T0) * theta + T0
    T_adiabatic = Tp + zdeps_km * Da
    T = torch.where(zdeps_km > z_adia, T_adiabatic, T)
    return T + C2K


class TherModel:
    """1-D thermal profile container (zdeps in km, T in K, P in Pa)."""

    def __init__(self, zdeps=None, T=None):
        self.zdeps = zdeps
        self.T = T
        self.P = None if zdeps is None else pressure(zdeps)
        self.rho = (None if (self.P is None or T is None)
                    else thermal_density(self.P, T, rho0=3.42e3))

    def copy(self):
        from copy import deepcopy
        return deepcopy(self)


class HSCM(TherModel):
    """Half-space cooling model (ThermSeis.py:56-101)."""

    def __init__(self, age, zdeps=None, rho0=3.43e3, Tp=1325.0, kappa=1e-6):
        age = _t(age)
        if zdeps is None:
            zdeps = torch.linspace(0.0, 200.0, 200, dtype=age.dtype,
                                   device=age.device)
        self.age = age
        self.zdeps = _t(zdeps, like=age)
        self.P = pressure(self.zdeps)
        self.T = hscm_temperature(age, self.zdeps, Tp=Tp, kappa=kappa)
        self.rho = thermal_density(self.P, self.T, rho0=rho0)


# --------------------------------------------------------------------------
# Solidus / melting
# --------------------------------------------------------------------------

def solidus(P_pa, which="Ruan2018"):
    """Peridotite solidus in K (ThermSeis.py:332-346)."""
    P = P_pa / 1e9
    if which == "Ruan2018":
        return -5.1 * P**2 + 92.5 * P + 1120.6 + C2K
    if which == "Hirschmann2009":
        return -5.1 * P**2 + 132.9 * P + 1120.6 + C2K
    if which == "Takei2017":
        z = P * 30.0
        return 1326.0 + (z - 50.0) + C2K
    return _t(which, like=P)  # numeric solidus


# --------------------------------------------------------------------------
# Ritzwoller 2004 mineral-physics conversion (ThermSeis.py:103-173)
# --------------------------------------------------------------------------

# rows: Olivine, Orthopyroxene, Clinopyroxene, Spinel, Garnet
# cols: rho0, rho_X, K0, K_T, K_P, K_X, mu0, mu_T, mu_P, mu_X,
#       alpha0, alpha1, alpha2, alpha3
_RITZ = np.array([
    [3.222e3, 1.182e3, 129, -16e-3, 4.2, 0, 82, -14e-3, 1.4, -30,
     0.2010e-4, 0.1390e-7, 0.1627e-2, -0.3380],
    [3.198e3, 0.804e3, 111, -12e-3, 6.0, -10, 81, -11e-3, 2.0, -29,
     0.3871e-4, 0.0446e-7, 0.0343e-2, -1.7278],
    [3.280e3, 0.377e3, 105, -13e-3, 6.2, 13, 67, -10e-3, 1.7, -6,
     0.3206e-4, 0.0811e-7, 0.1347e-2, -1.8167],
    [3.578e3, 0.702e3, 198, -28e-3, 5.7, 12, 108, -12e-3, 0.8, -24,
     0.6969e-4, -0.0108e-7, -3.0799e-2, 5.0395],
    [3.565e3, 0.758e3, 173, -21e-3, 4.9, 7, 92, -10e-3, 1.4, -7,
     0.0991e-4, 0.1165e-7, 1.0624e-2, -2.5000],
])
_RITZ_WS = np.array([0.75, 0.21, 0.035, 0.0, 0.005])  # mineral fractions


def ritzwoller_vs(T, P_gpa, X=0.1, ws=None, rho_type="raw", ther_rho=None):
    """Vs (km/s) from T (K) and P (GPa) via VRH averaging."""
    ws = _RITZ_WS if ws is None else np.asarray(ws)
    p = device_constant("ritz", lambda: _RITZ, T.dtype, T.device)
    T0, P0 = C2K, 101.325e-6
    Tc = T[..., None]
    Pc = P_gpa[..., None]
    alpha = p[:, 10] + p[:, 11] * Tc + p[:, 12] / Tc + p[:, 13] / Tc**2
    mu = p[:, 6] + (Tc - T0) * p[:, 7] + (Pc - P0) * p[:, 8] + X * p[:, 9]
    K = p[:, 2] + (Tc - T0) * p[:, 3] + (Pc - P0) * p[:, 4] + X * p[:, 5]
    if rho_type == "raw":
        rho0X = p[:, 0] * p[:, 1] / 1e3  # the reference's published formula
    else:
        rho0X = p[:, 0] + X * p[:, 1]
    rho = rho0X * (1 - alpha * (Tc - T0) + (Pc - P0) / K)

    w = (device_constant("ritz_ws", lambda: _RITZ_WS, T.dtype, T.device)
         if ws is _RITZ_WS else torch.as_tensor(ws, dtype=T.dtype,
                                                device=T.device))
    rho_vrh = torch.sum(w * rho, dim=-1)
    if rho_type == "from_thermal":
        rho_vrh = ther_rho
    mu_vrh = 0.5 * (torch.sum(w * mu, dim=-1)
                    + 1.0 / torch.sum(w / mu, dim=-1))
    mu_vrh = mu_vrh * 1e9
    return torch.sqrt(mu_vrh / rho_vrh) / 1000.0


# --------------------------------------------------------------------------
# Yamauchi & Takei 2016 anelasticity (ThermSeis.py:316-422)
# --------------------------------------------------------------------------

def _A_eta(Tn, gamma=5.0, Tn_eta=0.94):
    lo = Tn < Tn_eta
    mid = (~lo) & (Tn < 1.0)
    Tn_mid = torch.where(mid, Tn, 0.5)
    a_mid = torch.exp(-(Tn_mid - Tn_eta) / (Tn_mid - Tn_mid * Tn_eta)
                      * math.log(gamma))
    one = torch.ones_like(Tn)
    return torch.where(lo, one, torch.where(mid, a_mid, one / gamma))


def _A_P(Tn):
    return torch.where(Tn < 0.91, 0.01 * torch.ones_like(Tn),
                       torch.where(Tn < 0.96, 0.01 + 0.4 * (Tn - 0.91),
                                   0.03 * torch.ones_like(Tn)))


def _sig_P(Tn):
    return torch.where(Tn < 0.92, 4.0 * torch.ones_like(Tn),
                       torch.where(Tn < 1.0, 4.0 + 37.5 * (Tn - 0.92),
                                   7.0 * torch.ones_like(Tn)))


def yata_anelasticity(T, P, period, Tm="Takei2017"):
    """(J1, J2) compliances (ThermSeis.py:324-412).

    The Arrhenius viscosity spans ~1e18..1e76 Pa s over the temperature
    range of an oceanic plate — far outside float32 range at cold/shallow
    nodes — so everything downstream of it is computed in log space:
    ``eta`` is never materialized, only ``log(tau_ns)`` and
    ``lnr = log(tau_np) - log(tau_ns)`` are, and ``tau_ns ** alpha``
    becomes ``exp(alpha * log_tau_ns)``.
    """
    E, R, V = 4.625e5, 8.314, 7.913e-6
    etaR, TR, PR = 6.22e21, 1200 + C2K, 1.5e9
    A_B, tau_np, alpha = 0.664, 6e-5, 0.38

    Tn = T / solidus(P, Tm)
    mu_U = (72.45 - 0.01094 * (T - C2K) + 1.75 * P * 1e-9) * 1e9
    log_eta = (math.log(etaR) + E / R * (1 / T - 1 / TR)
               + V / R * (P / T - PR / TR) + torch.log(_A_eta(Tn)))
    log_tau_M = log_eta - torch.log(mu_U)
    log_tau_ns = math.log(period / (2 * math.pi)) - log_tau_M
    tau_ns_alpha = torch.exp(alpha * log_tau_ns)

    ap, sp = _A_P(Tn), _sig_P(Tn)
    lnr = math.log(tau_np) - log_tau_ns
    J1b = A_B * tau_ns_alpha / alpha
    J1p = (math.sqrt(2 * math.pi) / 2 * ap * sp
           * (1 - torch.erf(lnr / (math.sqrt(2.0) * sp))))
    J2b = math.pi / 2 * A_B * tau_ns_alpha
    J2p = math.pi / 2 * ap * torch.exp(-((lnr / (math.sqrt(2.0) * sp)) ** 2))
    J2e = torch.exp(log_tau_ns)
    return 1.0 + J1b + J1p, J2b + J2p + J2e


def yata_vs_qs(T, P, rho, period=50.0, Tm="Takei2017", mu_P=1.987):
    """Vs (km/s) and Qs from the YaTa model (ThermSeis.py:414-422)."""
    Ju = 1.0 / (72.45 - 0.01094 * (T - C2K) + mu_P * P / 1e9) * 1e-9
    J1, J2 = yata_anelasticity(T, P, period, Tm)
    vs = 1.0 / torch.sqrt(rho * Ju * J1) / 1000.0
    vs_unrelaxed = 1.0 / torch.sqrt(rho * Ju) / 1000.0
    # J2 underflows to 0 at cold nodes in f32 (the plate is elastic
    # there); floor it so Qs stays finite and qsinv = 1/Qs -> 0 cleanly.
    J2 = torch.clamp(J2, min=1e-30)
    return vs, J1 / J2, vs_unrelaxed


def ruan_vs_qs(T, P, rho, period=50.0):
    """Ruan 2018 variant: damp solidus, mu_P = 1.75 (ThermSeis.py:433-448)."""
    return yata_vs_qs(T, P, rho, period=period, Tm="Ruan2018", mu_P=1.75)


# --------------------------------------------------------------------------
# Jackson & Faul 2010 (ThermSeis.py:190-281) — fixed-node log quadrature
# --------------------------------------------------------------------------

_GL_NODES, _GL_WEIGHTS = np.polynomial.legendre.leggauss(64)


def _log_quad(f, lo, hi):
    """integral of f on [lo, hi] via 64-node Gauss-Legendre in log space."""
    nodes = torch.as_tensor(_GL_NODES, dtype=lo.dtype, device=lo.device)
    weights = torch.as_tensor(_GL_WEIGHTS, dtype=lo.dtype, device=lo.device)
    s_lo, s_hi = torch.log(lo), torch.log(hi)
    mid = 0.5 * (s_hi + s_lo)
    half = 0.5 * (s_hi - s_lo)
    s = mid[..., None] + half[..., None] * nodes
    tau = torch.exp(s)
    return torch.sum(f(tau) * tau * weights, dim=-1) * half


def jackson_faul(T, P, gs=1e-3, period=1.0):
    """(J1, J2, fM) creep compliances (ThermSeis.py:211-281).

    The reference integrates the relaxation spectra with an adaptive
    ``logQuad``; here a fixed 64-node log-Gauss rule, as in the JAX
    package.  The lower bound of the peak integral (0 in the reference)
    becomes tauP * exp(-10 * sig), far outside the Gaussian peak.
    """
    T = _t(T)
    P = _t(P, like=T)
    omega = 2 * math.pi / period
    Tr, Pr, gsr = 1173.0, 0.2e9, 1.34e-5
    tauLo, tauHo, tauMo = 1e-3, 1e7, 3.02e7
    deltaB, alpha = 1.04, 0.274
    ma, mv = 1.31, 3.0
    EB, AV, R = 3.6e5, 1e-5, 8.314
    tauPo, deltaP, sig = 3.98e-4, 0.057, 4.0
    cp = deltaP * (2 * math.pi) ** (-0.5) / sig

    gr = gs / gsr
    taut = torch.exp(EB / R * (1 / T - 1 / Tr)) * torch.exp(
        AV / R * (P / T - Pr / Tr))
    tauH = tauHo * gr**ma * taut
    tauL = tauLo * gr**ma * taut
    tauP = tauPo * gr**ma * taut
    tauM = tauMo * gr**mv * taut

    ij1 = _log_quad(lambda t: t ** (alpha - 1) / (1 + (omega * t) ** 2),
                    tauL, tauH)
    ij2 = _log_quad(lambda t: t**alpha / (1 + (omega * t) ** 2), tauL, tauH)

    def peak(t):
        g = torch.exp(-0.5 * (torch.log(t / tauP[..., None]) / sig) ** 2)
        return g / (1 + (omega * t) ** 2)

    lo_p = tauP * math.exp(-10.0 * sig)
    ip1 = _log_quad(lambda t: peak(t) / t, lo_p, tauH)
    ip2 = _log_quad(peak, lo_p, tauH)

    Jb1 = alpha * deltaB * ij1 / (tauH**alpha - tauL**alpha)
    Jb2 = omega * alpha * deltaB * ij2 / (tauH**alpha - tauL**alpha)
    J1 = 1.0 + Jb1 + cp * ip1
    J2 = Jb2 + cp * omega * ip2 + 1.0 / (omega * tauM)
    return J1, J2, 1.0 / tauM


# --------------------------------------------------------------------------
# Simpler published conversions
# --------------------------------------------------------------------------

def bass_vs(T, P, rho):
    """OceanSeisBass (ThermSeis.py:175-181)."""
    Ju = 1.0 / (66.5 - 0.0136 * (T - C2K - 900) + 1.8 * (P / 1e9 - 0.2)) * 1e-9
    return 1.0 / torch.sqrt(rho * Ju) / 1000.0


def stix_vs(T, zdeps_km):
    """OceanSeisStix (ThermSeis.py:183-188)."""
    return 4.77 + 0.038 * zdeps_km / 29.80 - 0.000378 * (T - 300.0)


_PM13_COEFFS = (3.9461e-9, -3.4761e-7, 9.9473e-6, -5.7175e-5, -2.3616e-3,
                0.054332, 0.55097)


def pm13_vs(T, P, rho, period=1.0):
    """OceanSeisPM13 (ThermSeis.py:283-314)."""
    Ju = 1.0 / (72.66 - 0.00871 * T + 2.04 * P / 1e9) * 1e-9
    E, Va, R = 402.9e3, 7.81e-6, 8.314
    Pr, Tr = 1.5e9, 1473.0
    eta0 = 10.0**22.38
    a_star = torch.exp((E + Pr * Va) / (R * Tr) - (E + P * Va) / (R * T))
    tauM = Ju * eta0 / a_star
    f_prime = tauM / period
    x = torch.log(f_prime)
    F = torch.zeros_like(x)
    for c in _PM13_COEFFS:  # Horner, as jnp.polyval
        F = F * x + c
    F = torch.where(f_prime > 1e13, 1.0, F)
    return 1.0 / torch.sqrt(rho * Ju / F) / 1000.0


def behn2009_shear(freq, d, T, P, coh=100.0):
    """Behn+ 2009 (ThermSeis.py:451-482): (Qinv, shear factor)."""
    T = _t(T) + 273.1
    pqref, pq = 1.09, 1.0
    dqref = 1.24e-5
    Eqref, Vqref = 505e3, 1.2e-5
    Bo, Eq, Vq = 1.28e8, 420e3, 1.2e-5
    cohref, R, Pqref, rq, alpha = 50.0, 8.314, 300e6, 1.2, 0.27
    Tqref = 1265.0
    B = (Bo * dqref ** (pq - pqref) * (coh / cohref) ** rq
         * math.exp(((Eq + Pqref * Vq) - (Eqref + Pqref * Vqref))
                    / R / Tqref))
    Qinv = (B * d ** (-pq) / freq
            * torch.exp(-(Eq + P * 1e9 * Vq) / R / T)) ** alpha
    F = (1.0 / math.tan(math.pi * alpha / 2)) / 2
    return Qinv, (1 - F * Qinv) ** 2


# --------------------------------------------------------------------------
# Reference-compatible class wrappers
# --------------------------------------------------------------------------

class SeisModel:
    def __init__(self, therModel=None, **kwargs):
        self.zdeps = None
        self.vs = None
        if therModel is not None:
            self.fromThermal(therModel, **kwargs)


class OceanSeisRitz(SeisModel):
    def __init__(self, therMod=None, **kwargs):
        self.X = kwargs.get("X", 0.1)
        self.ws = kwargs.get("ws", _RITZ_WS)
        self.RhoType = kwargs.get("RhoType", "raw")
        super().__init__(therMod)

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        self.vs = ritzwoller_vs(therMod.T, therMod.P / 1e9, X=self.X,
                                ws=self.ws, rho_type=self.RhoType,
                                ther_rho=therMod.rho)


class OceanSeisRuan(SeisModel):
    def __init__(self, therMod=None, period=50):
        self.period = period
        super().__init__(therMod)

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        self.vs, self.qs, self.vs_unrelaxed = ruan_vs_qs(
            therMod.T, therMod.P, therMod.rho, period=self.period)


class OceanSeisYaTa(SeisModel):
    def __init__(self, therMod=None, Tm="Takei2017", period=50):
        self.Tm, self.period = Tm, period
        super().__init__(therMod)

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        self.vs, self.qs, self.vs_unrelaxed = yata_vs_qs(
            therMod.T, therMod.P, therMod.rho, period=self.period,
            Tm=self.Tm)


class OceanSeisJack(SeisModel):
    def __init__(self, therMod=None, gs=1e-3, period=1):
        self.gs, self.period = gs, period
        super().__init__(therMod)

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        J1, J2, _ = jackson_faul(therMod.T, therMod.P, self.gs, self.period)
        Ju = 1.0 / (66.5 - 0.0136 * (therMod.T - C2K - 900)
                    + 1.8 * (therMod.P / 1e9 - 0.2)) * 1e-9
        self.vs = 1.0 / torch.sqrt(therMod.rho * Ju * J1) / 1000.0
        self.qs = J1 / J2
        self.vs_no_anelastic = 1.0 / torch.sqrt(therMod.rho * Ju) / 1000.0


class OceanSeisPM13(SeisModel):
    def __init__(self, therMod=None, period=1):
        self.period = period
        super().__init__(therMod)

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        self.vs = pm13_vs(therMod.T, therMod.P, therMod.rho, self.period)


class OceanSeisBass(SeisModel):
    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        self.vs = bass_vs(therMod.T, therMod.P, therMod.rho)


class OceanSeisStix(SeisModel):
    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        self.vs = stix_vs(therMod.T, therMod.zdeps)


class OceanSeisYaTa_unrelaxed(SeisModel):
    """Unrelaxed-modulus Vs only, no anelastic relaxation
    (ThermSeis.py:424-431)."""

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        Ju = 1.0 / (72.45 - 0.01094 * (therMod.T - C2K)
                    + 1.987 * therMod.P / 1e9) * 1e-9
        self.vs = 1.0 / torch.sqrt(therMod.rho * Ju) / 1000.0


class OceanSeisRuan_old(SeisModel):
    """Archival Ruan 2018 variant kept by the reference
    (ThermSeis.py:488-592): damp-switchable solidus (True = damp
    Ruan2018, False = Hirschmann2009, numeric = fixed Tm), J1-only
    velocity reduction, mu_P 1.75 (or YaTa's 1.987 with YaTaJu).

    Deliberate deviation, as in the JAX package: the reference's
    deprecated class stores vs in m/s (it never divides by 1000, unlike
    every other converter); here ``vs`` is km/s, so this class is
    interchangeable with the rest of the converter family."""

    def __init__(self, therMod=None, damp=True, YaTaJu=False, period=50):
        self.damp, self.YaTaJu, self.period = damp, YaTaJu, period
        super().__init__(therMod)

    def fromThermal(self, therMod):
        self._therMod = therMod
        self.zdeps = therMod.zdeps
        T, P, rho = therMod.T, therMod.P, therMod.rho
        mu_P = 1.987 if self.YaTaJu else 1.75
        Ju = 1.0 / (72.45 - 0.01094 * (T - C2K) + mu_P * P / 1e9) * 1e-9
        Tm = ("Ruan2018" if self.damp is True else
              "Hirschmann2009" if self.damp is False else self.damp)
        J1, J2 = yata_anelasticity(T, P, self.period, Tm=Tm)
        self.vs = 1.0 / torch.sqrt(rho * Ju * J1) / 1000.0
        self.vs_no_anelastic = 1.0 / torch.sqrt(rho * Ju) / 1000.0
        J2 = torch.clamp(J2, min=1e-30)
        self.qs = J1 / J2


behn2009Shear = behn2009_shear  # exact reference name (ThermSeis.py:451)

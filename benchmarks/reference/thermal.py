"""Plain reference of the oceanic-mantle thermal model and its seismic
conversions (half-space cooling, the Ruan 2018 solidus, the Ritzwoller
2004 mineral average for Vs, the Yamauchi & Takei 2016 anelasticity
for Qs), as the Cascadia-ocean mantle layer uses them.  Frozen copies of
the formulas of pySurfInv's ``ThermSeis.py``; tensors in, tensors out,
in the inputs' dtype and on their device."""

from __future__ import annotations

import math

import torch

C2K = 273.15
SEC_PER_YEAR = 365 * 24 * 3600.0

# rows: olivine, orthopyroxene, clinopyroxene, spinel, garnet; columns:
# rho0, rho_X, K0, K_T, K_P, K_X, mu0, mu_T, mu_P, mu_X, alpha0..alpha3
RITZ = (
    (3.222e3, 1.182e3, 129, -16e-3, 4.2, 0, 82, -14e-3, 1.4, -30,
     0.2010e-4, 0.1390e-7, 0.1627e-2, -0.3380),
    (3.198e3, 0.804e3, 111, -12e-3, 6.0, -10, 81, -11e-3, 2.0, -29,
     0.3871e-4, 0.0446e-7, 0.0343e-2, -1.7278),
    (3.280e3, 0.377e3, 105, -13e-3, 6.2, 13, 67, -10e-3, 1.7, -6,
     0.3206e-4, 0.0811e-7, 0.1347e-2, -1.8167),
    (3.578e3, 0.702e3, 198, -28e-3, 5.7, 12, 108, -12e-3, 0.8, -24,
     0.6969e-4, -0.0108e-7, -3.0799e-2, 5.0395),
    (3.565e3, 0.758e3, 173, -21e-3, 4.9, 7, 92, -10e-3, 1.4, -7,
     0.0991e-4, 0.1165e-7, 1.0624e-2, -2.5000),
)
RITZ_WS = (0.75, 0.21, 0.035, 0.0, 0.005)


def pressure(z_km):
    return 3.4e3 * 9.8 * z_km * 1000.0


def density(P, T, rho0=3.43e3):
    return rho0 * (1 - 4.4e-5 * (T - (500 + C2K))) * (1 + 6.12e-12 * (P - 0.6e9))


def hscm_temperature(age, z_km, Tp=1325.0):
    """Half-space cooling with an adiabat below its onset, in K; the
    mantle temperature and the onset depth by 16 bisection steps on
    [0, 400] km."""
    Da = 0.4
    scale = 2.0 * torch.sqrt(age * SEC_PER_YEAR)
    f = lambda z: torch.erf(z * 1e3 / scale)  # noqa: E731

    def g(z):
        fz = f(z)
        return fz / ((f(z + 0.001) - fz) / 0.001 + 1e-10) - z - Tp / Da

    z0, z1 = torch.zeros_like(age), torch.full_like(age, 400.0)
    for _ in range(16):
        z2 = 0.5 * (z0 + z1)
        neg = g(z2) < 0
        z0, z1 = torch.where(neg, z2, z0), torch.where(neg, z1, z2)
    Tm = (Da * z1 + Tp) / f(z1)
    T = Tm * torch.erf(z_km * 1e3 / scale)
    T = torch.where(z_km > z0, Tp + z_km * Da, T)
    return T + C2K


def solidus_ruan(P):
    p = P / 1e9
    return -5.1 * p ** 2 + 92.5 * p + 1120.6 + C2K


def ritzwoller_vs(T, P):
    """Vs (km/s) by the Voigt-Reuss-Hill average of five minerals at
    Fe content X = 0.1 (the published 'raw' density formula)."""
    p = torch.tensor(RITZ, dtype=T.dtype, device=T.device)
    w = torch.tensor(RITZ_WS, dtype=T.dtype, device=T.device)
    T0, P0, X = C2K, 101.325e-6, 0.1
    Tc, Pc = T[..., None], (P / 1e9)[..., None]
    alpha = p[:, 10] + p[:, 11] * Tc + p[:, 12] / Tc + p[:, 13] / Tc ** 2
    mu = p[:, 6] + (Tc - T0) * p[:, 7] + (Pc - P0) * p[:, 8] + X * p[:, 9]
    K = p[:, 2] + (Tc - T0) * p[:, 3] + (Pc - P0) * p[:, 4] + X * p[:, 5]
    rho = p[:, 0] * p[:, 1] / 1e3 * (1 - alpha * (Tc - T0) + (Pc - P0) / K)
    rho_vrh = torch.sum(w * rho, dim=-1)
    mu_vrh = 0.5 * (torch.sum(w * mu, dim=-1) + 1.0 / torch.sum(w / mu, dim=-1))
    return torch.sqrt(mu_vrh * 1e9 / rho_vrh) / 1000.0


def ruan_qs(T, P, rho, period):
    """Qs of the Yamauchi & Takei 2016 model with the Ruan 2018 damp
    solidus (mu_P 1.75), computed in log space."""
    E, R, V = 4.625e5, 8.314, 7.913e-6
    etaR, TR, PR = 6.22e21, 1200 + C2K, 1.5e9
    A_B, tau_np, alpha = 0.664, 6e-5, 0.38
    Tn = T / solidus_ruan(P)
    one = torch.ones_like(Tn)
    mid = (Tn >= 0.94) & (Tn < 1.0)
    Tn_mid = torch.where(mid, Tn, 0.5 * one)
    a_eta = torch.where(Tn < 0.94, one, torch.where(
        mid, torch.exp(-(Tn_mid - 0.94) / (Tn_mid - Tn_mid * 0.94)
                       * math.log(5.0)), one / 5.0))
    mu_U = (72.45 - 0.01094 * (T - C2K) + 1.75 * P * 1e-9) * 1e9
    log_eta = (math.log(etaR) + E / R * (1 / T - 1 / TR)
               + V / R * (P / T - PR / TR) + torch.log(a_eta))
    log_tau_ns = math.log(period / (2 * math.pi)) - (log_eta - torch.log(mu_U))
    tau_a = torch.exp(alpha * log_tau_ns)
    ap = torch.where(Tn < 0.91, 0.01 * one, torch.where(
        Tn < 0.96, 0.01 + 0.4 * (Tn - 0.91), 0.03 * one))
    sp = torch.where(Tn < 0.92, 4.0 * one, torch.where(
        Tn < 1.0, 4.0 + 37.5 * (Tn - 0.92), 7.0 * one))
    lnr = math.log(tau_np) - log_tau_ns
    J1 = (1.0 + A_B * tau_a / alpha + math.sqrt(2 * math.pi) / 2 * ap * sp
          * (1 - torch.erf(lnr / (math.sqrt(2.0) * sp))))
    J2 = (math.pi / 2 * A_B * tau_a
          + math.pi / 2 * ap * torch.exp(-((lnr / (math.sqrt(2.0) * sp)) ** 2))
          + torch.exp(log_tau_ns))
    return J1 / torch.clamp(J2, min=1e-30)

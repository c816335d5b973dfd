"""PREM (isotropic, oceanless) layered model for kernel defaults.

Counterpart of the JAX package's ``data/prem.py``, with its own copy of
the table.  The reference package bundles a PREM layer table so
``SensKernel()`` works with no arguments (``senskernel.py:6-11`` of the
reference); the table here is regenerated from the published PREM
polynomial parameterisation (Dziewonski & Anderson, PEPI 25, 1981, Table
1 — isotropic Vp/Vs/rho as polynomials in normalised radius x = r/6371).
The 3 km ocean is replaced by upper crust (the "crustal PREM" convention
for continental-kernel defaults), and the table stops at the 670 km
discontinuity — ample for T <= 100 s fundamental/first-overtone kernels.
"""

from __future__ import annotations

import numpy as np

_A = 6371.0  # Earth radius, km

# depth range (km), polynomial coeffs in x = r/_A (constant, linear),
# for Vp, Vs, rho, and Q_mu — PREM isotropic, crust extended to z = 0.
_REGIONS = [
    # z_top, z_bot, Vp(c0,c1), Vs(c0,c1), rho(c0,c1), Qmu, n_layers
    (0.0, 15.0, (5.8, 0.0), (3.2, 0.0), (2.6, 0.0), 600.0, 4),
    (15.0, 24.4, (6.8, 0.0), (3.9, 0.0), (2.9, 0.0), 600.0, 3),
    (24.4, 80.0, (4.1875, 3.9382), (2.1519, 2.3481),
     (2.6910, 0.6924), 600.0, 8),
    (80.0, 220.0, (4.1875, 3.9382), (2.1519, 2.3481),
     (2.6910, 0.6924), 80.0, 20),
    (220.0, 400.0, (20.3926, -12.2569), (8.9496, -4.4597),
     (7.1089, -3.8045), 143.0, 18),
    (400.0, 600.0, (39.7027, -32.6166), (22.3512, -18.5856),
     (11.2494, -8.0298), 143.0, 20),
    (600.0, 660.0, (19.0957, -9.8672), (9.9839, -4.9324),
     (5.3197, -1.4836), 143.0, 6),
]


def _poly(coeffs, x):
    c0, c1 = coeffs
    return c0 + c1 * x


def prem_model():
    """PREM as a layered DataFrame with columns H, Vp, Vs, Rho, Qs."""
    import pandas as pd

    H, Vp, Vs, Rho, Qs = [], [], [], [], []
    for z_top, z_bot, cvp, cvs, crho, qmu, n in _REGIONS:
        edges = np.linspace(z_top, z_bot, n + 1)
        for i in range(n):
            zm = 0.5 * (edges[i] + edges[i + 1])
            x = (_A - zm) / _A
            H.append(edges[i + 1] - edges[i])
            Vp.append(round(float(_poly(cvp, x)), 5))
            Vs.append(round(float(_poly(cvs, x)), 5))
            Rho.append(round(float(_poly(crho, x)), 5))
            Qs.append(qmu)
    return pd.DataFrame(
        {"H": H, "Vp": Vp, "Vs": Vs, "Rho": Rho, "Qs": Qs})


def write_csv(path):
    """Write the table as a reference-format csv (H,Vp,Vs,Rho,Qs)."""
    prem_model().to_csv(path, index=False)
    return path

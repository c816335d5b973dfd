"""Drop-in compatibility shim for reference pySurfInv call sites.

``fast_surf`` mimics the f2py extension's signature
(``fast_surf_src/fast_surf.pyf:6-19`` of the reference):

    (ur0, ul0, cr0, cl0) = fast_surf(nlay, ilvry, vp, vs, rho, h,
                                     qsinv, per, nper)

with 200-element output arrays, so code written against
``pySurfInv.fast_surf`` runs unchanged on the port's single-model solver.
Counterpart of the JAX package's ``compat.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def fast_surf(n_layer, kind, a_ref, b_ref, rho_ref, d_ref, qs_ref,
              cvper, ncvper, *, device="cuda"):
    """Single-model Rayleigh/Love dispersion, fast_surf calling convention.

    Args mirror FAST_SURF (fast_surf.f:2-5): ``kind`` 2 = Rayleigh,
    1 = Love; ``qs_ref`` is 1/Qs; ``cvper`` padded period array with
    ``ncvper`` real entries.  Solves in float64 on ``device``.  Returns
    four float32 arrays of length 200: (uR, uL, cR, cL), zeros where not
    computed.
    """
    from pysurfinv_tpu_torch.models.model1d import padded_profile
    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward

    n = int(n_layer)
    periods = np.asarray(cvper, dtype=float)[: int(ncvper)]
    H, VP, VS, RHO, QSI, nlay = padded_profile(
        np.asarray(d_ref)[:n], np.asarray(b_ref)[:n], np.asarray(a_ref)[:n],
        np.asarray(rho_ref)[:n], 1.0 / np.asarray(qs_ref)[:n])
    wave = "rayleigh" if int(kind) == 2 else "love"
    t = lambda x: torch.as_tensor(x, dtype=torch.float64,  # noqa: E731
                                  device=device)
    c, u, ok = surf_forward(t(H), t(VP), t(VS), t(RHO), t(QSI), t(periods),
                            nlay, wave=wave, cfg=SurfConfig())
    ok = ok[:, 0].cpu().numpy()
    c = np.where(ok, c[:, 0].cpu().numpy(), 0.0)
    u = np.where(ok, u[:, 0].cpu().numpy(), 0.0)

    ur0, ul0, cr0, cl0 = (np.zeros(200, np.float32) for _ in range(4))
    n = len(periods)
    if int(kind) == 2:
        cr0[:n], ur0[:n] = c, u
    else:
        cl0[:n], ul0[:n] = c, u
    return ur0, ul0, cr0, cl0

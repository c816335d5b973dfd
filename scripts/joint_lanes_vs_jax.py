"""Solve named lanes of ``chip_smoke.py``'s joint phase with both packages.

``chip_smoke.py`` (phase 4b) names the (model, period index) lanes where
the joint solve's Rayleigh root differs from the independent Rayleigh
solve by more than 1e-4 km/s.  This script rebuilds the same bench batch
(seed 0), takes the joint solve's calibration offset at each named
period from the same strided 512 models, and solves the named models at
that period (a lane's bracket and root depend only on its own period
there: the first period is solved cold, and the seeded sweep is one
lane per period) twice in each package, seeded from the Love roots as
the joint solve does and cold as the independent solve does: the JAX
package with its Pallas kernels in interpret mode, the port with its
plain versions, float32 on the CPU.  A difference that the JAX package
shows too is the reference's own behaviour, not a fault of the port.
Last, each named lane's float64 root (the port's single-model solve).

Run from the repository root on a CPU with JAX installed (a few
minutes):

    python3 scripts/joint_lanes_vs_jax.py 3031:0 6965:0 9874:0
"""

import os
import sys
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NSUB = 512
WSEED = dict(wseed_nscan=8, wseed_backoff=4, wseed_coarse=0)


def offsets(solve, batch, nlay, calib, T, cfg_r, cfg_l):
    """The joint solve's calibration offset median(cL - cR) at period T
    over the calibration models."""
    cL, okL = solve(batch[calib], nlay, T, "love", cfg_l)
    cR, okR = solve(batch[calib], nlay, T, "rayleigh",
                    replace(cfg_r, compute_group=False, nbisect=3))
    return float(np.nanmedian(np.where(okL & okR, cL - cR, np.nan)))


def seeded_and_cold(solve, batch, nlay, models, T, offs, cfg_r, cfg_l):
    cL, okL = solve(batch[models], nlay, T, "love", cfg_l)
    c_pred = np.where(okL, cL - offs, 0.0).astype(np.float32)
    seeded = solve(batch[models], nlay, T, "rayleigh",
                   replace(cfg_r, **WSEED), c_warm=c_pred)
    cold = solve(batch[models], nlay, T, "rayleigh", cfg_r)
    return seeded, cold


def jax_solver():
    from pysurfinv_tpu.testing import force_cpu
    force_cpu(1, x64=False)
    import jax.numpy as jnp

    from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward_batch

    def solve(b, nlay, T, wave, cfg, c_warm=None):
        jcfg = SurfConfig(**{k: getattr(cfg, k) for k in SurfConfig._fields
                             if k != "backend"}, backend="pallas_interpret")
        c, _, ok = surf_forward_batch(
            *(jnp.asarray(b[:, i]) for i in range(5)),
            jnp.asarray([T], jnp.float32),
            jnp.full((b.shape[0],), nlay, jnp.int32), wave=wave, cfg=jcfg,
            c_warm=None if c_warm is None else jnp.asarray(c_warm[:, None]))
        return np.asarray(c)[:, 0, 0], np.asarray(ok)[:, 0, 0]
    return solve


def port_solver():
    import torch

    from pysurfinv_tpu_torch.ops.dispersion import surf_forward_batch

    def solve(b, nlay, T, wave, cfg, c_warm=None):
        c, _, ok = surf_forward_batch(
            *(torch.from_numpy(np.ascontiguousarray(b[:, i]))
              for i in range(5)),
            torch.tensor([T], dtype=torch.float32),
            torch.full((b.shape[0],), nlay, dtype=torch.int32), wave=wave,
            cfg=replace(cfg, backend="plain"),
            c_warm=None if c_warm is None else torch.from_numpy(
                c_warm[:, None]))
        return c.numpy()[:, 0, 0], ok.numpy()[:, 0, 0]
    return solve


def main():
    import chip_smoke as cs
    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig

    lanes = [tuple(int(x) for x in a.split(":")) for a in sys.argv[1:]]
    if not lanes:
        raise SystemExit(__doc__)
    batch, nlay = cs.bench_batch(cs.B_SLICE, seed=0)
    stride = cs.B_SLICE // NSUB
    calib = np.arange(0, stride * NSUB, stride)
    cfg_r = SurfConfig(nmodes=1, nscan_first=512, nscan=12, nbisect=8,
                       warm_backoff=4, coarse_first=16)
    cfg_l = replace(cfg_r, nbisect=6)
    for name, solve in (("port (plain versions)", port_solver()),
                        ("JAX (Pallas interpret)", jax_solver())):
        for p in sorted({p for _, p in lanes}):
            T = float(cs.PERIODS[p])
            models = [m for m, q in lanes if q == p]
            offs = offsets(solve, batch, nlay, calib, T, cfg_r, cfg_l)
            (cs_, oks), (cc, okc) = seeded_and_cold(
                solve, batch, nlay, models, T, offs, cfg_r, cfg_l)
            print(f"{name}: T = {T} s, calibration offset {offs:.7f} km/s")
            for i, m in enumerate(models):
                print(f"  model {m}: seeded {cs_[i]:.6f} (ok {oks[i]}), "
                      f"cold {cc[i]:.6f} (ok {okc[i]}), |dc| "
                      f"{abs(cs_[i] - cc[i]):.3e} km/s", flush=True)
    # the lanes' float64 roots: the port's single-model solve, converged
    import torch

    from pysurfinv_tpu_torch.ops.dispersion import surf_forward
    for m, p in lanes:
        b = batch[m].astype(np.float64)
        c, _, _ = surf_forward(*(torch.from_numpy(b[i]) for i in range(5)),
                               torch.tensor([float(cs.PERIODS[p])],
                                            dtype=torch.float64), nlay,
                               cfg=SurfConfig(nbisect=30))
        print(f"float64 root, model {m}, T = {cs.PERIODS[p]} s: "
              f"{float(c[0, 0]):.6f} km/s")


if __name__ == "__main__":
    main()

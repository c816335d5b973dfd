"""Point observations and the batched MCMC entry point ``MCinvMP``.

Counterpart of the JAX package's ``inversion/point.py``: the Point
observation container (point.py:8-14), its likelihood as a lane-batched
function of predicted phase velocities, the reference npz chain writer,
and ``MCinvMP`` — all of one point's chain segments as lanes of the
batched sampler, routed through :func:`..parallel.grid.invert_grid`.

Not ported yet (ROADMAP.md): ``Point.misfit`` and the host-sequential
``MCinv`` oracle, which need the single-model forward, and
``PostPoint``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pysurfinv_tpu_torch.models.model1d import buildModel1D


def _lanes_ok(cP, valid):
    """All predicted velocities >= 0.01 km/s over the real periods
    (models.py:29 ``any(c < 0.01)`` -> failed forward)."""
    if valid is None:
        return (cP >= 0.01).all(dim=-1)
    return torch.where(valid, cP >= 0.01, True).all(dim=-1)


def _finish(ok, chi, N):
    misfit = torch.sqrt(chi / N)
    chi = torch.where(chi < 50, chi, torch.sqrt(chi * 50.0))
    L = torch.exp(-0.5 * chi)
    fail = torch.full_like(chi, 88888.0)
    return (torch.where(ok, misfit, fail), torch.where(ok, chi, fail),
            torch.where(ok, L, 0.0))


class Point:
    """Observed dispersion + a starting model (point.py:8-14)."""

    def __init__(self, setting=None, localInfo=None, modelTypeCustom=None,
                 layerClassCustom=None, periods=(), vels=(), uncers=()):
        self.initMod = buildModel1D(setting, localInfo or {},
                                    modelTypeCustom=modelTypeCustom,
                                    layerClassCustom=layerClassCustom or {})
        self.obs = {"T": periods, "c": vels, "uncer": uncers}
        self.pid = "test"

    def misfit(self, model=None):
        """The host misfit of one model (point.py:15-31)."""
        raise NotImplementedError(
            "Point.misfit needs Model1D.forward, the single-model solve, "
            "not ported yet (ROADMAP.md Queue 1 item 7)")

    def MCinv(self, *args, **kwargs):
        """The host-sequential Metropolis oracle (point.py:32-89)."""
        raise NotImplementedError(
            "Point.MCinv needs Model1D.forward, the single-model solve, "
            "not ported yet (ROADMAP.md Queue 1 item 7); MCinvMP runs "
            "the batched sampler")

    def MCinvMP(self, outdir="MCtest", pid=None, runN=50000, chainL=1000,
                nprocess=None, seed=42, priori=False, verbose=True,
                wave="rayleigh", segment=100, device="cuda"):
        """All ``runN // chainL`` chain segments as lanes of the batched
        sampler on one card (point.py:90-125), written as
        ``{outdir}/{pid}.npz`` in the reference chain format.

        Delegates to :func:`pysurfinv_tpu_torch.parallel.grid.invert_grid`
        with this single point, so the lanes' keys — and the tracks —
        equal those of ``invert_grid`` with the same seed.  ``nprocess``
        is accepted for API compatibility and ignored: the unit of
        parallelism is a lane, not a process.
        """
        from pysurfinv_tpu_torch.parallel.grid import invert_grid

        if priori and outdir.split("_")[-1] != "priori":
            outdir = "_".join((outdir, "priori"))
        pid = self.pid if pid is None else pid
        if verbose:
            print(f"Running MC inversion: {pid}")
        t0 = time.time()
        invert_grid([self], [(0.0, 0.0)], outdir=outdir, runN=runN,
                    chainL=chainL, seed=seed, priori=priori, wave=wave,
                    segment=segment, verbose=False, pids=[pid],
                    device=device)
        if verbose:
            print(f"Time cost:{time.time() - t0:.2f} ")

    # ---- the likelihood, lane-batched ------------------------------------
    @staticmethod
    def _misfit_from_c(cP, T, obs_c, uncer, obs_m, valid=None):
        """Per-lane misfit from predicted phase velocities (point.py:
        15-31: plain chi^2, soft cap above 50, 88888 sentinel).

        Args (each (N, P), a lane per row; ``obs_m``/``valid`` bool):
          cP:    predicted phase velocities (0 where the solve failed).
          T:     periods (used by band-split subclasses).
          obs_c: observed velocities, 0 where masked.
          uncer: observation uncertainties.
          obs_m: True where an observation exists.
          valid: optional, restricts the failed-forward check to real
                 (unpadded) periods; None checks every entry.
        Returns (misfit, chiSqr, L), each (N,).
        """
        ok = _lanes_ok(cP, valid)
        N = obs_m.sum(dim=-1).clamp(min=1)
        chi = torch.where(obs_m, ((obs_c - cP) / uncer) ** 2, 0.0).sum(-1)
        return _finish(ok, chi, N)

    def _obs_arrays(self):
        """(T, obs_c, uncer, obs_m) as float64 numpy arrays; masked
        observations (a numpy masked array ``c``) become obs_m False."""
        T = np.asarray(self.obs["T"], dtype=float)
        cO = np.ma.masked_array(np.asarray(self.obs["c"], dtype=float))
        mask = ~np.ma.getmaskarray(cO) & np.ones(len(T), bool)
        return (T, np.where(mask, cO.filled(0.0), 0.0),
                np.asarray(self.obs["uncer"], dtype=float), mask)

    def _save_npz(self, outdir, pid, mcTrack, chainL):
        from pysurfinv_tpu_torch.utils import savez_fast
        os.makedirs(outdir, exist_ok=True)
        path = f"{outdir}/{pid}.npz"
        savez_fast(path, mcTrack=mcTrack,
                   setting=dict(self.initMod.toYML()), obs=self.obs,
                   invMeta={"pid": pid, "chainL": chainL})
        return path

    def copy(self):
        from copy import deepcopy
        return deepcopy(self)


class PointCascadia(Point):
    """Band-split misfit: mean chi^2 of T <= 40 s and T > 40 s averaged
    (point.py:336-366)."""

    @staticmethod
    def _misfit_from_c(cP, T, obs_c, uncer, obs_m, valid=None):
        """Band-split lane misfit (point.py:336-366): chi^2 is the
        average of the T <= 40 s and T > 40 s mean-square biases, scaled
        back to N observations; band counts are per lane, so lanes whose
        period lists differ share one call."""
        ok = _lanes_ok(cP, valid)
        lo = obs_m & (T <= 40)
        hi = obs_m & (T > 40)
        n_lo, n_hi = lo.sum(-1), hi.sum(-1)
        N = (n_lo + n_hi).clamp(min=1)
        b2 = torch.where(obs_m, ((obs_c - cP) / uncer) ** 2, 0.0)
        m_lo = torch.where(lo, b2, 0.0).sum(-1) / n_lo.clamp(min=1)
        m_hi = torch.where(hi, b2, 0.0).sum(-1) / n_hi.clamp(min=1)
        chi = torch.where((n_lo > 0) & (n_hi > 0), (m_lo + m_hi) / 2 * N,
                          torch.where(n_lo > 0, m_lo * N, m_hi * N))
        return _finish(ok, chi, N)

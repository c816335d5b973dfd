"""Point observations, the MCMC entry points and posterior analysis.

Counterpart of the JAX package's ``inversion/point.py``: the Point
observation container (point.py:8-14) with its host misfit and the
host-sequential Metropolis oracle ``MCinv`` (point.py:15-89), its
likelihood as a lane-batched function of predicted phase velocities, the
reference npz chain writer, ``MCinvMP`` — all of one point's chain
segments as lanes of the batched sampler (or of the per-chain legacy
sampler), routed through :func:`..parallel.grid.invert_grid` with its
checkpoints and lane ranges — and ``PostPoint``, the posterior
statistics and plots over the npz chain format (point.py:134-332).
Every entry point that solves takes ``device=`` (default ``"cuda"``).
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from pysurfinv_tpu_torch.models.model1d import buildModel1D

# Failure classes of compiling a custom (non-catalog) model family:
# structure freezing raises ValueError/KeyError/AttributeError, a layer
# without a lane mode TypeError or NotImplementedError.  The posterior
# fallbacks catch exactly these and nothing else.
_NONCOMPILABLE_ERRORS = (TypeError, ValueError, KeyError, AttributeError,
                         NotImplementedError)


def _soft_cap(chiSqr):
    """chi^2 soft cap above 50 (point.py:29)."""
    return chiSqr if chiSqr < 50 else np.sqrt(chiSqr * 50.0)


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

    def misfit(self, model=None, device="cuda"):
        """The host misfit of one model (point.py:15-31): (misfit,
        chiSqr, L), with 88888 / 0 when the forward failed."""
        model = self.initMod if model is None else model
        T = self.obs["T"]
        cP = model.forward(periods=T, device=device)
        if cP is None:
            return 88888, 88888, 0
        cO = self.obs["c"]
        if not np.ma.isMaskedArray(cO):
            cO = np.ma.masked_array(cO)
        uncer = self.obs["uncer"]
        N = cO.count()
        chiSqr = (((cO - cP) / uncer) ** 2).sum()
        misfit = np.sqrt(chiSqr / N)
        chiSqr = _soft_cap(chiSqr)
        return misfit, chiSqr, np.exp(-0.5 * chiSqr)

    def MCinv(self, outdir="MCtest", pid=None, runN=50000, chainL=1000,
              init=True, seed=None, verbose=False, priori=False,
              isgood=None, device="cuda"):
        """Sequential Metropolis sampler on host model objects (semantics
        of point.py:32-89), every forward solved on ``device``.

        The cross-validation oracle for the batched chains: one
        ``runN``-step run, restarted from a fresh uniform draw every
        ``chainL`` steps (the first segment starts from ``initMod``),
        recording a row for every proposal with the accept flag in
        column 2 — the npz chain format.  The Metropolis rule, restart
        policy and Python ``random`` call order follow the reference, so
        a seeded run gives the JAX package's tracks.  ``isgood``
        (optional) replaces ``model.isgood()`` for perturb and reset.
        Returns the last proposal.
        """
        prior_ok = isgood if isgood is not None else (lambda m: m.isgood())
        random.seed(seed)
        pid = pid if pid is not None else self.pid
        t_start = time.time()
        rows = [0] * runN
        current = proposal = None
        cur_chi = None
        for step in range(runN):
            if step % chainL == 0:
                if init:   # first segment only: start from initMod
                    init, current = False, self.initMod.copy()
                    if not prior_ok(current):
                        current = current.perturb(prior_ok)
                else:      # later segments: uniform re-draw
                    current = self.initMod.reset(prior_ok)
                    if verbose is True:
                        print(f"{step + 1}/{runN} Time cost:"
                              f"{time.time() - t_start:.2f} ")
                cur_misfit, cur_chi, cur_L = self.misfit(current, device)
                current._dump(step, rows, [cur_misfit, cur_L, 1])
                continue
            proposal = current.perturb(prior_ok)
            if priori:
                proposal._dump(step, rows, [0, 1, 1])
                current = proposal
                continue
            new_misfit, new_chi, new_L = self.misfit(proposal, device)
            # Metropolis on the soft-capped chi^2; the uniform draw is
            # consumed only on non-improving proposals (short-circuit),
            # as in the reference's RNG stream
            take = (new_chi < cur_chi
                    or random.random() > 1 - np.exp(-(new_chi - cur_chi)
                                                    / 2))
            proposal._dump(step, rows, [new_misfit, new_L, int(take)])
            if take:
                current = proposal
                cur_chi = new_chi
        self._save_npz(outdir, pid, np.array(rows), chainL)
        return proposal

    def MCinvMP(self, outdir="MCtest", pid=None, runN=50000, chainL=1000,
                nprocess=None, seed=42, priori=False, verbose=True,
                wave="rayleigh", segment=100, device="cuda",
                sampler="batched", checkpoint=None, resume=False):
        """All ``runN // chainL`` chain segments as lanes of one sampler
        (point.py:90-125), written as ``{outdir}/{pid}.npz`` in the
        reference chain format.

        Delegates to :func:`pysurfinv_tpu_torch.parallel.grid.invert_grid`
        with this single point.  ``sampler="batched"`` (the default) runs
        the batched sampler, whose lanes' keys — and tracks — equal those
        of ``invert_grid`` with the same seed; ``"legacy"`` the JAX
        package's per-chain kernel with its keys ``split(PRNGKey(seed),
        n_chains)``, each chain's forward the single-model float64 solve.
        ``device`` may be a list of devices (the chains split into lane
        ranges, one process each); ``checkpoint`` / ``resume`` as in
        ``invert_grid`` (batched sampler).  ``nprocess`` is accepted for
        API compatibility and ignored: the unit of parallelism is a lane,
        not a process.
        """
        from pysurfinv_tpu_torch.inversion import random as R
        from pysurfinv_tpu_torch.parallel.grid import invert_grid

        if priori and outdir.split("_")[-1] != "priori":
            outdir = "_".join((outdir, "priori"))
        pid = self.pid if pid is None else pid
        if verbose:
            print(f"Running MC inversion: {pid}")
        t0 = time.time()
        legacy = dict(_point_keys=R.PRNGKey(seed)[None],
                      _check_all_periods=True) if sampler == "legacy" else {}
        invert_grid([self], [(0.0, 0.0)], outdir=outdir, runN=runN,
                    chainL=chainL, seed=seed, priori=priori, wave=wave,
                    segment=segment, verbose=False, pids=[pid],
                    device=device, sampler=sampler, checkpoint=checkpoint,
                    resume=resume, **legacy)
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

    def misfit(self, model=None, device="cuda"):
        """The band-split host misfit of one model (point.py:336-366)."""
        model = self.initMod if model is None else model
        T = np.array(self.obs["T"])
        cP = model.forward(periods=T, device=device)
        if cP is None:
            return 88888, 88888, 0
        cO = self.obs["c"]
        if not np.ma.isMaskedArray(cO):
            cO = np.ma.masked_array(cO)
        uncer = self.obs["uncer"]
        N = cO.count()
        bias = (cO - cP) / uncer
        b1, b2 = bias[T <= 40], bias[T > 40]
        if not np.all(b1.mask) and not np.all(b2.mask):
            chiSqr = ((b1**2).mean() + (b2**2).mean()) / 2 * N
        elif np.all(b1.mask):
            chiSqr = (b2**2).mean() * N
        elif np.all(b2.mask):
            chiSqr = (b1**2).mean() * N
        else:
            raise ValueError("All observations are masked???")
        misfit = np.sqrt(chiSqr / N)
        chiSqr = _soft_cap(chiSqr)
        return misfit, chiSqr, np.exp(-0.5 * chiSqr)

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


def _interp_lanes(x, xp, fp, edges=False):
    """``jnp.interp(x, xp[n], fp[n], left=nan, right=nan)`` for each row n
    of (N, M) ``xp``/``fp`` at the (Z,) points ``x``: (N, Z).  Same index
    rule (searchsorted right) and zero-width guard as JAX's, so nodes
    repeated at layer interfaces resolve alike.  ``edges=True`` gives
    ``jnp.interp``'s defaults instead: the first / last value outside
    the row's range."""
    N, M = xp.shape
    xs = x.expand(N, -1).contiguous()
    i = torch.searchsorted(xp.contiguous(), xs, right=True).clamp(1, M - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    dx = x1 - x0
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, f0,
                    f0 + ((xs - x0) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    if edges:
        f = torch.where(xs < xp[:, :1], fp[:, :1], f)
        return torch.where(xs > xp[:, -1:], fp[:, -1:], f)
    out = (xs < xp[:, :1]) | (xs > xp[:, -1:])
    return torch.where(out, torch.full_like(f, np.nan), f)


class PostPoint(Point):
    """Posterior reconstruction from the npz chain format
    (point.py:134-332).  ``device`` solves the avg/min models' forwards
    and builds the batched Vs(z) values."""

    def __init__(self, npzMC=None, npzPriori=None, modelTypeCustom=None,
                 layerClassCustom=None, trueMarkovChain=True,
                 device="cuda"):
        self.device = device
        if npzMC is not None:
            tmp = np.load(npzMC, allow_pickle=True)
            self.MC = tmp["mcTrack"]
            setting, self.obs = tmp["setting"][()], tmp["obs"][()]
            self.invMeta = tmp["invMeta"][()]
            self.initMod = buildModel1D(setting,
                                        modelTypeCustom=modelTypeCustom,
                                        layerClassCustom=layerClassCustom
                                        or {})
            self.N = self.MC.shape[0]
            self.misfits = self.MC[:, 0]
            self.Ls = self.MC[:, 1]
            self.accepts = self.MC[:, 2]
            self.MCparas = self.MC[:, 3:]
            self.MCparas_pri = None

            if trueMarkovChain:
                # rejected rows inherit the last accepted parameters
                # (point.py:152-157)
                iAcc = 0
                for i in range(self.N):
                    if self.accepts[i]:
                        iAcc = i
                    else:
                        self.MCparas[i, :] = self.MCparas[iAcc, :]

            indMin = np.nanargmin(self.misfits)
            self.minMod = self.initMod.copy()
            self.minMod._loadMC(self.MCparas[indMin])
            self.minMod.L = self.Ls[indMin]
            self.minMod.misfit = self.misfits[indMin]

            self.thres = self._thres(self.minMod.misfit)
            self.accFinal = self.misfits < self.thres

            self.avgMod = self.initMod.copy()
            self.avgMod._loadMC(np.mean(self.MCparas[self.accFinal, :],
                                        axis=0))
            self.avgMod.misfit, _, self.avgMod.L = self.misfit(
                model=self.avgMod, device=device)

        if npzPriori is not None:
            tmp = np.load(npzPriori, allow_pickle=True)["mcTrack"]
            self.MCparas_pri = tmp[:, 3:]

    @staticmethod
    def _thres(minMisfit):
        """Acceptance threshold (point.py:307-309)."""
        return max(minMisfit * 2, minMisfit + 0.5)

    def _model_generator(self, indSteps=None, priori=False):
        mod = self.initMod.copy()
        if indSteps is None:
            indSteps = (np.where(self.accFinal)[0] if not priori
                        else range(len(self.misfits)))
        mcParas = self.MCparas if not priori else self.MCparas_pri
        for ind in indSteps:
            mod._loadMC(mcParas[ind, :])
            yield mod.copy()

    def _loadValues(self, indVars="all", zdeps=None, indSteps=None,
                    priori=False):
        if zdeps is not None:
            if indSteps is None:
                indSteps = (np.where(self.accFinal)[0] if not priori
                            else range(len(self.misfits)))
            mcParas = self.MCparas if not priori else self.MCparas_pri
            thetas = np.asarray(mcParas[np.asarray(list(indSteps), int)],
                                float)
            try:
                return self._batched_values(np.asarray(zdeps, float), thetas)
            except _NONCOMPILABLE_ERRORS as e:
                # custom layer classes outside the lane catalog fail
                # structure freezing with exactly these classes; anything
                # else (a device fault, a numeric error) propagates
                import warnings
                warnings.warn(
                    "PostPoint batched evaluation failed "
                    f"({type(e).__name__}: {e}); using the slow host "
                    "loop. If this model family compiled before, this "
                    "is a regression.", RuntimeWarning, stacklevel=2)
                vals = [mod.value(zdeps) for mod in
                        self._model_generator(indSteps, priori=priori)]
                return np.array(vals).T
        indVars = (range(len(self.initMod._brownians()))
                   if indVars == "all" else indVars)
        mcParas = (self.MCparas[self.accFinal] if not priori
                   else self.MCparas_pri[self.accFinal])
        return np.array([mc[list(indVars)] for mc in mcParas]).T

    def _compiled(self):
        if getattr(self, "_cm_post", None) is None:
            from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
            self._cm_post = CompiledModel(self.initMod)
        return self._cm_post

    def _batched_values(self, zdeps, thetas, chunk=2048):
        """Vs(zdeps) for a stack of MC parameter vectors: the lane build of
        :class:`CompiledModel` in chunks of ``chunk`` models, float64 on
        ``self.device``, in place of the reference's Pool(20).map over
        per-model rebuilds (point.py:319-326).  Returns (len(zdeps),
        n_models)."""
        cm = self._compiled()
        n = cm._n_nodes_main  # value() interpolates refLayer=False grids
        f64 = dict(dtype=torch.float64, device=self.device)
        zj = torch.as_tensor(zdeps, **f64)
        outs = []
        for i in range(0, len(thetas), chunk):
            z, vs, *_ = cm.build_grids(torch.as_tensor(thetas[i:i + chunk],
                                                       **f64))
            outs.append(_interp_lanes(zj, z[:, :n], vs[:, :n]).cpu().numpy())
        return np.concatenate(outs, axis=0).T

    # ---- plots (capabilities of point.py:177-304) ------------------------
    # Styling constants (grey lw=0.1 alpha=0.2 ensembles, the Vs xlim
    # windows, errorbar caps) are the reference's, so figures stay
    # comparable with published ones.  matplotlib is imported inside.

    def _sample_accepted(self, k):
        """Up to k randomly drawn accepted-model indices (with
        replacement, like the reference's random.choices)."""
        pool = np.flatnonzero(self.accFinal)
        if len(pool) == 0:
            return np.array([], dtype=int)
        return np.asarray(random.choices(pool,
                                         k=min(k, int(len(pool)))))

    def _ensemble_models(self, k):
        yield from self._model_generator(self._sample_accepted(k))

    def plotDisp(self, ax=None, ensemble=True):
        """Observed dispersion (error bars) vs initial/avg/min-misfit
        predictions, over a grey accepted-ensemble cloud."""
        import matplotlib.pyplot as plt
        T = np.asarray(self.obs["T"], dtype=float)
        fwd = lambda m: m.forward(T, device=self.device)  # noqa: E731
        if ax is None:
            ax = plt.figure().gca()
        if ensemble:
            cloud = np.array([fwd(m) for m in self._ensemble_models(500)])
            if len(cloud):
                ax.plot(T, cloud.T, color="grey", lw=0.1, alpha=0.2)
        ax.errorbar(T, self.obs["c"], self.obs["uncer"], ls="None",
                    color="k", capsize=3, capthick=2, elinewidth=2,
                    label="Observation")
        ax.plot(T, fwd(self.initMod), label="Initial")
        ax.plot(T, fwd(self.avgMod), label="Avg accepted")
        ax.plot(T, fwd(self.minMod), label="Min misfit")
        ax.legend()
        ax.set_title("Dispersion")
        return ax.figure, ax

    def _plot_vs_ensemble(self, drawer, k, xlim, ax=None, cloud=None):
        """Shared scaffold of the Vs-profile plots: initial model, grey
        ensemble, then avg/min overlays.  ``cloud(ax, k) -> bool`` may
        draw the whole ensemble in one batched call; the host per-model
        loop is the fallback."""
        import matplotlib.pyplot as plt
        ax = drawer(self.initMod, label="Initial", ax=ax)
        if cloud is None or not cloud(ax, k):
            for mod in self._ensemble_models(k):
                drawer(mod, ax=ax, color="grey", lw=0.1, alpha=0.2)
        drawer(self.avgMod, label="Avg", ax=ax)
        drawer(self.minMod, label="Min", ax=ax)
        ax.set_xlim(*xlim)
        ax.legend()
        plt.sca(ax)
        return ax

    def _grid_ensemble_cloud(self, ax, k):
        """Draw the k-member fine-grid ensemble as one LineCollection, every
        (z, vs) grid from one lane build of the compiled model.  Returns
        False when the model family does not compile (the host loop
        takes over)."""
        picks = self._sample_accepted(k)
        if len(picks) == 0:
            return True
        try:
            from matplotlib.collections import LineCollection
            cm = self._compiled()
            n = cm._n_nodes_main
            z, vs, *_ = cm.build_grids(torch.as_tensor(
                np.asarray(self.MCparas[picks], float), dtype=torch.float64,
                device=self.device))
            zs, vss = z[:, :n].cpu().numpy(), vs[:, :n].cpu().numpy()
        except _NONCOMPILABLE_ERRORS as e:  # same policy as _loadValues
            import warnings
            warnings.warn(
                f"batched ensemble drawing failed ({type(e).__name__}: "
                f"{e}); using the slow host loop.", RuntimeWarning,
                stacklevel=2)
            return False
        segs = [np.column_stack([v, z]) for z, v in zip(zs, vss)]
        ax.add_collection(LineCollection(segs, colors="grey",
                                         linewidths=0.1, alpha=0.2))
        return True

    def plotVsProfile(self, allAccepted=False):
        """Layered (staircase) Vs-profile ensemble (point.py:196-205)."""
        def layered(mod, ax=None, **kw):
            return mod.plotProfile(ax=ax, **kw)
        return self._plot_vs_ensemble(layered,
                                      self.N if allAccepted else 2000,
                                      xlim=(3.8, 4.8))

    def plotVsProfileGrid(self, allAccepted=False, ax=None):
        """Fine-grid Vs-profile ensemble (point.py:206-215); the grey
        cloud is one batched compiled-model build."""
        def gridded(mod, ax=None, **kw):
            return mod.plotProfileGrid(ax=ax, **kw)
        return self._plot_vs_ensemble(gridded,
                                      self.N if allAccepted else 2000,
                                      xlim=(3.0, 4.8), ax=ax,
                                      cloud=self._grid_ensemble_cloud)

    def plotVsProfileShaded(self):
        """Avg model with a +-1 sigma posterior band (point.py:216-228)."""
        import matplotlib.pyplot as plt
        zdeps = np.linspace(0, 200, 200)
        spread = self._loadValues(zdeps=zdeps).std(axis=1)
        center = self.avgMod.value(zdeps)
        ax = self.initMod.plotProfileGrid(label="Initial", alpha=0.2)
        ax.fill_betweenx(zdeps, center + spread, center - spread,
                         facecolor="grey", alpha=0.6)
        self.avgMod.plotProfileGrid(ax=ax, label="Avg")
        ax.set_xlim(3.0, 4.8)
        ax.legend()
        plt.sca(ax)
        return ax

    def _check_distribution(self, indVars="all", zdeps=None):
        import matplotlib.pyplot as plt
        accYs = self._loadValues(indVars, zdeps, priori=False)
        priYs = (self._loadValues(indVars, zdeps, priori=True)
                 if self.MCparas_pri is not None else None)
        indVars = (range(len(self.initMod._brownians()))
                   if indVars == "all" else indVars)
        titles = ([f"Parameter index {i}" for i in indVars]
                  if zdeps is None else [f"Hist of Vs at {z} km"
                                         for z in zdeps])
        for i, title in enumerate(titles):
            plt.figure()
            if priYs is not None:
                _, bin_edges = np.histogram(priYs[i], bins=30)
                plt.hist(accYs[i], bins=bin_edges,
                         weights=np.ones_like(accYs[i]) / len(accYs[i]),
                         fill=True, ec="k", rwidth=0.8)
                plt.hist(priYs[i], bins=bin_edges,
                         weights=np.ones_like(priYs[i]) / len(priYs[i]),
                         fill=False, ec="k", rwidth=1.0)
            else:
                plt.hist(accYs[i], bins=30)
            plt.title(title)

    def _check_convergency(self, indVars="all", zdeps=None):
        import matplotlib.pyplot as plt
        chainL = self.invMeta["chainL"]
        chainLTests = [int(l) for l in np.linspace(chainL / 10, chainL, 20)]

        def indChainLTest(chainLTest):
            N = len(self.misfits)
            ind = np.zeros(N, dtype=bool)
            i = 0
            while i < N:
                ind[i:i + chainLTest] = True
                i += chainL
            return ind

        indVars = (range(len(self.initMod._brownians()))
                   if indVars == "all" else indVars)
        nVars = len(list(indVars)) if zdeps is None else len(zdeps)
        yMean = np.zeros([nVars, len(chainLTests)])
        yStd = np.zeros([nVars, len(chainLTests)])
        for j, cl in enumerate(chainLTests):
            ind = indChainLTest(cl)
            thres = self._thres(self.misfits[ind].min())
            accInd = np.where((self.misfits < thres) * ind)[0]
            values = self._loadValues(indVars, zdeps, accInd)
            yMean[:, j] = values.mean(axis=1)
            yStd[:, j] = values.std(axis=1)
        plt.figure()
        for i in range(nVars):
            plt.plot(chainLTests, yMean[i])
        plt.title("Mean")
        plt.figure()
        for i in range(nVars):
            plt.plot(chainLTests, yStd[i])
        plt.title("Standard Deviation")

    def _check_history(self, yType="ksquare"):
        import matplotlib.pyplot as plt
        plt.figure()
        if yType == "ksquare":
            y = self.misfits**2 * len(self.obs["T"])
            thres = self.thres**2 * len(self.obs["T"])
        elif yType == "likelihood":
            y, thres = self.Ls, None
        elif yType == "misfit":
            y, thres = self.misfits, self.thres
        else:
            raise ValueError(f"Unsupported type of y: {yType}")
        plt.plot(y)
        ind = np.where(self.accepts.astype(bool))[0]
        plt.plot(ind, y[ind], "or")
        if thres:
            plt.plot([0, self.N], [thres, thres], "--g")


class PostPointCascadia(PostPoint):
    misfit = PointCascadia.misfit

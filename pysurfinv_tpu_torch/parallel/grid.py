"""Grid inversion on one card: every (point, chain) lane in one sampler.

Counterpart of the JAX package's ``parallel/grid.py`` with its batched
sampler.  The reference runs each geographic point as a separate OS job
writing ``lon_lat.npz`` (model3D.py:36-57), with chains as separate
processes per point (point.py:90-107).  Here all points of one model
*structure* (the YAML setting) and all their chains are lanes of one
batched sampler: points differ only through per-point constants (psi:
water depth, sediment thickness, plate age, topo) and per-point
Brownian bounds, both lane tensors, and every Metropolis step solves
all lanes' forwards in one ``surf_forward_batch`` call — the secular
kernels of ``ops/secular_lanes.py`` on the card.

Not ported (ROADMAP.md): meshes and sharding over several cards, the
traced-program caches, mid-chain checkpoint/resume and the per-chain
"legacy" sampler.

Output: one ``{lon:g}_{lat:g}.npz`` per point in the reference chain
format, directly consumable by PostPoint / Model3D.loadInvDir.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

# seconds to wait before the n-th retry of a segment, times n
RETRY_BACKOFF_S = 10.0


def mcmc_solver_cfg():
    """The dispersion-solver configuration of the MCMC sampler — the JAX
    package's, with the same defaults and the same ``PYSURFINV_MCMC_*``
    variables (parallel/grid.py:213-280 there documents how each value
    was measured): a fused ``c_warm`` sweep of 32 dc from 12 dc below
    the previous evaluated root at an 8 dc step, then 3 separated
    safeguarded-Newton gradient launches; no group velocity.
    ``PYSURFINV_MCMC_NNEWTON`` / ``PYSURFINV_MCMC_FUSE_ILL`` route the
    refinement through the fused ``refine_lanes`` kernel instead (the
    variables win only when ``PYSURFINV_MCMC_NEWTON_SEP=0``, as in the
    JAX package, whose solver tests ``newton_sep`` first).
    """
    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig
    e = os.environ.get
    return SurfConfig(nmodes=1, compute_group=False,
                      nscan=int(e("PYSURFINV_MCMC_NSCAN", 32)),
                      warm_backoff=int(e("PYSURFINV_MCMC_BACKOFF", 12)),
                      nbisect=int(e("PYSURFINV_MCMC_NBISECT", 11)),
                      coarse=int(e("PYSURFINV_MCMC_COARSE", 8)),
                      fuse_illinois=e("PYSURFINV_MCMC_FUSE_ILL", "0") == "1",
                      nnewton=int(e("PYSURFINV_MCMC_NNEWTON", 0)),
                      newton_sep=int(e("PYSURFINV_MCMC_NEWTON_SEP", 3)),
                      fhandoff=e("PYSURFINV_MCMC_FHANDOFF", "0") == "1",
                      coarse_first=8)


def chi_sqr_fn(cm, pcls, wave, scfg):
    """The lanes' likelihood ``(thetas, ctx, c_warm) -> (misfit, chi, L,
    roots)``: the compiled model's profiles, one batched solve seeded
    with ``c_warm`` (the roots of each lane's last evaluated proposal,
    0 = cold), ``pcls._misfit_from_c`` over the real periods.  Lane
    context ``ctx = (psi, periods, obs_c, uncer, obs_m)``."""
    from pysurfinv_tpu_torch.ops.dispersion import surf_forward_batch

    def chi_sqr_batch(thetas, ctx, c_warm):
        psi, per, obs_c, uncer, obs_m = ctx
        prof = cm.build_profile_batch(thetas, psi)
        # the solve runs in float32, the kernels' type, on every device
        f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
        c, _, ok = surf_forward_batch(*map(f32, prof[:5]), f32(per),
                                      prof[5], wave=wave, cfg=scfg,
                                      c_warm=c_warm)
        cP = torch.where(ok[:, :, 0], c[:, :, 0], 0.0)
        m, chi, L = pcls._misfit_from_c(cP.to(thetas.dtype), per, obs_c,
                                        uncer, obs_m, valid=obs_m)
        # cP of THIS evaluation seeds the next step's brackets (zeros
        # where the solve failed -> those lanes re-bracket cold)
        return m, chi, L, cP

    return chi_sqr_batch


def batched_sampler(cm, pcls, cfg, wave, scfg):
    """(init_fn, segment_fn) of the grid sampler: the prior is the
    compiled model's, the likelihood :func:`chi_sqr_fn`'s; each lane
    carries the roots of its last evaluated proposal (``aux``) to seed
    the next step's brackets."""
    from pysurfinv_tpu_torch.inversion.mcmc import make_segmented_sampler

    def isgood(thetas, ctx):
        return cm.isgood(thetas, ctx[0])

    return make_segmented_sampler(
        isgood, chi_sqr_fn(cm, pcls, wave, scfg), cfg,
        aux_init=lambda spec, ctx: torch.zeros_like(ctx[1],
                                                    dtype=torch.float32))


def _transient(e):
    """Faults worth re-running a segment for: the card busy with another
    process, or memory another process holds for the moment."""
    msg = str(e)
    return isinstance(e, RuntimeError) and (
        "busy or unavailable" in msg or "out of memory" in msg)


def invert_grid(points, lonlats, outdir="mcdata", runN=24000, chainL=800,
                seed=42, priori=False, wave="rayleigh", device="cuda",
                verbose=True, point_cls=None, sampler="batched",
                segment=100, retries=2, checkpoint=None, resume=False,
                max_lanes="auto", pids=None, _lane_offset=0):
    """Run MCMC for many grid points as one batched computation.

    Args:
      points:  Point objects sharing one model structure (their initMod
               settings differ only in numeric values).
      lonlats: (lon, lat) per point, for the output file names.
      outdir:  directory for the reference-format npz chain files
               (``_priori`` is appended when ``priori``).
      runN, chainL, seed, priori: as in Point.MCinvMP; each point runs
               ``runN // chainL`` chains of ``chainL`` steps, chain 0
               from the point's initial model, the others from uniform
               draws.
      device:  where the sampler runs; the card unless the caller asks
               for the CPU (which runs the kernels' plain versions).
      point_cls: Point subclass whose ``_misfit_from_c`` is the
               likelihood of every lane; default ``type(points[0])``,
               with a homogeneity check.
      sampler: "batched" (the only one ported).
      segment: run the chain in segments of this many steps (None = one
               piece).  Every step's draws are a pure function of (lane
               key, global step), so the tracks do not depend on it.
      retries: re-run a segment from its start this many times after a
               transient fault (see ``_transient``).  The sampler is
               deterministic, so a retry continues the exact chain.
      max_lanes: "auto" runs up to 8,192 (point, chain) lanes at once and
               tiles larger grids at 1,024 lanes; an integer tiles at
               that lane count; None never tiles.  Lane keys are offset
               per tile, so tiled and untiled runs give the same tracks.
      pids:    optional output basenames overriding ``lon_lat``.
      checkpoint, resume: not ported (ROADMAP.md); must stay unset.

    Returns the list of written file paths.
    """
    from pysurfinv_tpu_torch.convert import spec_from_numpy
    from pysurfinv_tpu_torch.inversion import random as R
    from pysurfinv_tpu_torch.inversion.compiled import (BrownianSpec,
                                                        CompiledModel)
    from pysurfinv_tpu_torch.inversion.mcmc import ChainConfig

    if sampler != "batched":
        raise NotImplementedError(
            f"invert_grid: sampler={sampler!r} is not ported (ROADMAP.md); "
            "the batched sampler is")
    if checkpoint is not None or resume:
        raise NotImplementedError(
            "invert_grid: checkpoint/resume is not ported yet (ROADMAP.md)")
    if priori and outdir.split("_")[-1] != "priori":
        outdir = "_".join((outdir, "priori"))

    FALLBACK_LANES = 1024
    AUTO_CEILING = 8192
    nch = max(runN // chainL, 1)
    lane_limit = AUTO_CEILING if max_lanes == "auto" else max_lanes
    if lane_limit and len(points) > 1 and len(points) * nch > lane_limit:
        per = max(1, (FALLBACK_LANES if max_lanes == "auto" else max_lanes)
                  // nch)
        paths = []
        for i in range(0, len(points), per):
            paths += invert_grid(
                points[i:i + per], lonlats[i:i + per], outdir=outdir,
                runN=runN, chainL=chainL, seed=seed, priori=priori,
                wave=wave, device=device, verbose=verbose,
                point_cls=point_cls, segment=segment, retries=retries,
                max_lanes=None, pids=pids[i:i + per] if pids else None,
                _lane_offset=_lane_offset + i * nch)
        return paths

    t0 = time.time()
    K = len(points)
    cm = CompiledModel(points[0].initMod)

    # ---- point-class likelihood (homogeneous per call) -----------------
    pcls = point_cls or type(points[0])
    bad = [type(p).__name__ for p in points if type(p) is not pcls]
    if bad and point_cls is None:
        raise ValueError(
            f"invert_grid requires a homogeneous point class per call "
            f"(got {pcls.__name__} and {sorted(set(bad))}); split the "
            f"grid by class, or pass point_cls explicitly to override")

    # ---- per-point stacks: specs, psi, padded observations -------------
    specs = [cm.spec_of(p.initMod) for p in points]
    spec_np = BrownianSpec(*(np.stack([getattr(s, f) for s in specs])
                             for f in BrownianSpec._fields))
    psi_np = np.stack([cm.psi_of(p.initMod) for p in points])
    obs = [p._obs_arrays() for p in points]
    P_max = max(len(o[0]) for o in obs)
    periods = np.zeros((K, P_max))
    obs_c = np.zeros((K, P_max))
    uncer = np.ones((K, P_max))
    obs_m = np.zeros((K, P_max), dtype=bool)
    for k, (T, c, u, m) in enumerate(obs):
        n = len(T)
        periods[k, :n] = T
        periods[k, n:] = T[-1]  # padded periods solve but are masked
        obs_c[k, :n], uncer[k, :n], obs_m[k, :n] = c, u, m

    # ---- lanes: (point, chain), point-major ------------------------------
    n_real = K * nch
    lanes = lambda x: torch.as_tensor(  # noqa: E731
        np.repeat(x, nch, axis=0), device=device)
    spec_l, psi_l = spec_from_numpy(
        tuple(np.repeat(f, nch, axis=0) for f in spec_np),
        np.repeat(psi_np, nch, axis=0), device=device)
    ctx_l = (psi_l, lanes(periods), lanes(obs_c), lanes(uncer),
             lanes(obs_m))
    use_init = torch.as_tensor(np.tile(np.arange(nch) == 0, K),
                               device=device)
    lane_keys = R.fold_in(R.PRNGKey(seed, device=device),
                          torch.arange(n_real, device=device) + _lane_offset)

    cfg = ChainConfig(chain_len=chainL, priori=priori)
    init_fn, seg_fn = batched_sampler(cm, pcls, cfg, wave, mcmc_solver_cfg())
    carry = init_fn(lane_keys, spec_l, ctx_l, spec_l.theta0, use_init)
    t_init = time.time()

    seg = chainL if segment is None else min(max(int(segment), 1), chainL)
    tracks = np.empty((n_real, chainL, 3 + cm.ntheta), np.float64)
    s, tries = 0, 0
    while s < chainL:
        n = min(seg, chainL - s)
        try:
            new_carry, rows = seg_fn(carry, lane_keys, spec_l, ctx_l, s, n)
            host = rows.cpu().numpy()
        except RuntimeError as e:
            if tries >= retries or not _transient(e):
                raise
            tries += 1
            if verbose:
                print(f"invert_grid: transient fault ({e}), retry "
                      f"{tries}/{retries} from step {s}")
            time.sleep(RETRY_BACKOFF_S * tries)
            continue
        tries = 0
        tracks[:, s:s + n] = np.moveaxis(host, 0, 1)
        carry = new_carry
        s += n
    t_run = time.time()

    # ---- reference-format npz per point --------------------------------
    os.makedirs(outdir, exist_ok=True)
    tracks = tracks.reshape(K, nch * chainL, -1)

    def _write(k):
        lon, lat = lonlats[k]
        pid = pids[k] if pids else f"{lon:g}_{lat:g}"
        return points[k]._save_npz(outdir, pid, tracks[k], chainL)

    if K > 4:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=8) as pool:
            paths = list(pool.map(_write, range(K)))
    else:
        paths = [_write(k) for k in range(K)]
    if verbose:
        print(f"invert_grid: {K} points x {nch} chains x {chainL} steps on "
              f"{device}: init {t_init - t0:.1f} s, segments "
              f"{t_run - t_init:.1f} s, write {time.time() - t_run:.1f} s")
    return paths

"""Grid inversion: every (point, chain) lane in one sampler, on one card or
split into lane ranges over several.

Counterpart of the JAX package's ``parallel/grid.py``.  The reference runs
each geographic point as a separate OS job writing ``lon_lat.npz``
(model3D.py:36-57), with chains as separate processes per point
(point.py:90-107).  Here all points of one model *structure* (the YAML
setting) and all their chains are lanes of one batched sampler: points
differ only through per-point constants (psi: water depth, sediment
thickness, plate age, topo) and per-point Brownian bounds, both lane
tensors, and every Metropolis step solves all lanes' forwards in one
``surf_forward_batch`` call — the secular kernels of
``ops/secular_lanes.py`` on the card.

Beside the batched sampler:

  * checkpoint/resume — after each committed segment the carry (dtypes
    kept) and the rows so far are written atomically; a resumed run
    gives the tracks of the uninterrupted one, bit for bit;
  * lane ranges — ``device`` may be a list: the lanes split into
    contiguous ranges, one per entry, each run by a spawned process of
    its own (the sampler's host loop holds the GIL, so threads would
    serialise); every lane's key follows its global index, so the tracks
    do not depend on the split;
  * the streamed npz writer — rows are deflated lane by lane as each
    segment lands, and the files are assembled without recompression
    (``PYSURFINV_STREAM_NPZ=0`` writes with ``savez_fast`` instead);
  * the per-chain "legacy" sampler (``sampler="legacy"``), whose forward
    is the single-model float64 ``surf_forward`` and launches no kernel.

Output: one ``{lon:g}_{lat:g}.npz`` per point in the reference chain
format, directly consumable by PostPoint / Model3D.loadInvDir.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pysurfinv_tpu_torch import profiling

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


def legacy_chi_sqr_fn(cm, pcls, wave, check_all_periods=False):
    """The legacy sampler's likelihood ``(thetas, ctx) -> (misfit, chi,
    L)``: each lane's forward is the single-model float64 solve
    ``CompiledModel.forward`` (as in the JAX package, which solves each
    chain's model on its own), the misfit ``pcls._misfit_from_c`` on the
    batch.  ``check_all_periods`` tests every period for a failed solve
    (``Point.MCinvMP``'s convention) instead of the observed ones."""

    def chi_sqr(thetas, ctx):
        psi, per, obs_c, uncer, obs_m = ctx
        cP = torch.stack([cm.forward(thetas[j], per[j], psi=psi[j],
                                     wave=wave)
                          for j in range(thetas.shape[0])])
        return pcls._misfit_from_c(cP, per, obs_c, uncer, obs_m,
                                   valid=None if check_all_periods
                                   else obs_m)

    return chi_sqr


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


def _devices(device):
    """``device`` as a list of entries: a string or ``torch.device`` is
    one entry, any other sequence is taken as it is."""
    if isinstance(device, (str, torch.device)):
        return [device]
    devs = list(device)
    if not devs:
        raise ValueError("invert_grid: empty device list")
    return devs


def _delta(before, after):
    """Counters counted between two :func:`profiling.counters` reads."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _add(total, part):
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def _run_lanes(job, lo, hi, device, checkpoint):
    """Run lanes [lo, hi) of ``job`` on ``device``.

    ``job`` holds everything as host objects (numpy lane arrays, the
    model, the point class, the configs), so the same call runs in this
    process or in a spawned one.  Returns a dict: ``tracks`` (n, chainL,
    3 + ntheta) float64 lane-major, ``lane_parts`` (each lane's deflate
    chunks, or None), ``seconds``, ``launches`` (the kernel launch
    counts of this call) and ``counters`` (what
    :func:`profiling.counters` counted over it: the launches alone
    unless counting is on).
    """
    from pysurfinv_tpu_torch.convert import spec_from_numpy
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel

    t0 = time.time()
    before = profiling.counters()
    cm = CompiledModel(job["model"])
    sel = lambda x: np.ascontiguousarray(x[lo:hi])  # noqa: E731
    spec_l, psi_l = spec_from_numpy(tuple(sel(f) for f in job["spec"]),
                                    sel(job["psi"]), device=device)
    ctx_l = (psi_l, *(torch.as_tensor(sel(job[k]), device=device)
                      for k in ("periods", "obs_c", "uncer", "obs_m")))
    use_init = torch.as_tensor(sel(job["use_init"]), device=device)
    keys = torch.as_tensor(sel(job["keys"]), device=device)
    cfg = job["cfg"]
    if job["sampler"] == "legacy":
        from pysurfinv_tpu_torch.inversion.mcmc import make_chain_kernel
        kernel = make_chain_kernel(
            lambda th, ctx: cm.isgood(th, ctx[0]),
            legacy_chi_sqr_fn(cm, job["pcls"], job["wave"],
                              job["check_all_periods"]), cfg)
        tracks = kernel(keys, spec_l, ctx_l, spec_l.theta0,
                        use_init).cpu().numpy()
        lane_parts = None
    else:
        tracks, lane_parts = _segments(job, cm, keys, spec_l, ctx_l,
                                       use_init, device, checkpoint,
                                       lane0=lo)
    counted = _delta(before, profiling.counters())
    return dict(tracks=tracks, lane_parts=lane_parts,
                seconds=time.time() - t0,
                launches={k[len("kernel."):]: v for k, v in counted.items()
                          if k.startswith("kernel.")},
                counters=counted)


def _segments(job, cm, keys, spec_l, ctx_l, use_init, device, checkpoint,
              lane0):
    """The batched sampler's segment loop on one lane range: atomic
    checkpoint after each committed segment, resume, roll back to the
    last committed segment on a transient fault, rows deflated lane by
    lane as they land."""
    from pysurfinv_tpu_torch.utils import StreamingLaneCompressor

    cfg, chainL = job["cfg"], job["cfg"].chain_len
    verbose, retries = job["verbose"], job["retries"]
    abort_after = job["abort_after_segments"]
    init_fn, seg_fn = batched_sampler(cm, job["pcls"], cfg, job["wave"],
                                      job["scfg"])
    n = keys.shape[0]
    seg = (chainL if job["segment"] is None
           else min(max(int(job["segment"]), 1), chainL))
    tracks = np.empty((n, chainL, 3 + cm.ntheta), np.float64)
    zc = (StreamingLaneCompressor(n) if job["stream_npz"] else None)
    ck_meta = dict(job["ck_meta"], n_lanes=n, lane0=lane0)

    def store(host_rows, s_after):
        """Lay one committed segment's (time-major) rows into the
        lane-major buffer and queue them for deflation."""
        n0 = host_rows.shape[0]
        tracks[:, s_after - n0:s_after] = np.moveaxis(host_rows, 0, 1)
        if zc is not None:
            zc.feed(tracks, s_after - n0, s_after)

    def to_device(host_carry):
        return tuple(torch.as_tensor(c, device=device) for c in host_carry)

    s, sync = 0, None   # sync: (step, host carry) of the last commit
    if job["resume"] and checkpoint and os.path.exists(checkpoint):
        ck = np.load(checkpoint)
        got = {k: int(ck[k]) for k in ck_meta if k in ck}
        if got != ck_meta:
            if zc is not None:
                zc.abort()
            raise ValueError(
                f"checkpoint {checkpoint} was written by a different run "
                f"configuration: saved {got}, current {ck_meta}; delete "
                f"it or rerun with the original settings")
        s = int(ck["s"])
        n_carry = sum(1 for k in ck.files if k.startswith("carry"))
        sync = (s, tuple(ck[f"carry{i}"] for i in range(n_carry)))
        if s > 0:
            store(ck["rows"], s)
        if verbose:
            print(f"invert_grid: resumed at step {s} from {checkpoint}")
    carry = (to_device(sync[1]) if sync is not None
             else init_fn(keys, spec_l, ctx_l, spec_l.theta0, use_init))

    n_done, tries = 0, 0
    try:
        while s < chainL:
            n_seg = min(seg, chainL - s)
            try:
                new_carry, rows = seg_fn(carry, keys, spec_l, ctx_l, s,
                                         n_seg)
                with profiling.annotate("pysurfinv.store"):
                    host_rows = rows.cpu().numpy()
                    host_carry = tuple(c.cpu().numpy() for c in new_carry)
                    profiling.count("host_syncs", 1 + len(host_carry))
            except RuntimeError as e:
                if tries >= retries or not _transient(e):
                    raise
                tries += 1
                if verbose:
                    back = sync[0] if sync is not None else "init"
                    print(f"invert_grid: transient fault ({e}), retry "
                          f"{tries}/{retries} from step {back}")
                time.sleep(RETRY_BACKOFF_S * tries)
                # roll back to the last committed segment (or re-init)
                if sync is None:
                    s = 0
                    carry = init_fn(keys, spec_l, ctx_l, spec_l.theta0,
                                    use_init)
                else:
                    s, carry = sync[0], to_device(sync[1])
                continue
            tries = 0
            s += n_seg
            with profiling.annotate("pysurfinv.store"):
                store(host_rows, s)
            carry, sync = new_carry, (s, host_carry)
            n_done += 1
            if checkpoint:
                # rows so far, time-major as the segments return them
                tmp = checkpoint + ".tmp.npz"
                with profiling.annotate("pysurfinv.checkpoint"):
                    with open(tmp, "wb") as fh:
                        np.savez(fh, s=s,
                                 rows=np.moveaxis(tracks[:, :s], 0, 1),
                                 **ck_meta,
                                 **{f"carry{i}": c
                                    for i, c in enumerate(host_carry)})
                    os.replace(tmp, checkpoint)
            if (abort_after is not None and n_done >= abort_after
                    and s < chainL):
                # testing hook: the process dies mid-run
                raise KeyboardInterrupt(f"aborted after {n_done} segments")
    except BaseException:
        if zc is not None:
            zc.abort()
        raise
    if zc is None:
        return tracks, None
    zc.close()
    return tracks, [zc.lane_chunks(i, i + 1) for i in range(n)]


def _range_main(job, lo, hi, device, checkpoint, n_threads):
    """Entry point of a spawned lane-range process."""
    torch.set_num_threads(n_threads)
    with profiling.counting(job["count"]):
        return _run_lanes(job, lo, hi, device, checkpoint)


def _run_ranges(job, devices, checkpoint, verbose, stats):
    """Split the job's lanes over ``devices``: in this process for one
    entry, else one spawned process per contiguous range (each range's
    seconds, kernel launch counts and counters go to ``stats["ranges"]``,
    its counters also into ``stats["counters"]``).
    Returns the lane-major tracks and the lanes' deflate chunks (or
    None)."""
    from pysurfinv_tpu_torch.parallel.mesh import lane_ranges

    n = len(job["keys"])
    ranges = lane_ranges(n, len(devices))
    if len(ranges) == 1:
        res = [_run_lanes(job, 0, n, devices[0], checkpoint)]
    else:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        threads = torch.get_num_threads()
        with ProcessPoolExecutor(len(ranges),
                                 mp_context=mp.get_context("spawn")) as ex:
            futs = [ex.submit(_range_main, job, lo, hi, str(devices[j]),
                              f"{checkpoint}.range{j}" if checkpoint
                              else None, threads)
                    for j, (lo, hi) in enumerate(ranges)]
            res = [f.result() for f in futs]
        for j, ((lo, hi), r) in enumerate(zip(ranges, res)):
            stats.setdefault("ranges", []).append(
                dict(device=str(devices[j]), lanes=(lo, hi),
                     seconds=r["seconds"], launches=r["launches"],
                     counters=r["counters"]))
            _add(stats.setdefault("counters", {}), r["counters"])
            if verbose:
                print(f"invert_grid: range {j} lanes [{lo}, {hi}) on "
                      f"{devices[j]}: {r['seconds']:.1f} s")
    tracks = np.concatenate([r["tracks"] for r in res])
    parts = (None if res[0]["lane_parts"] is None
             else [p for r in res for p in r["lane_parts"]])
    return tracks, parts


def invert_grid(points, lonlats, outdir="mcdata", runN=24000, chainL=800,
                seed=42, priori=False, wave="rayleigh", device="cuda",
                verbose=True, point_cls=None, sampler="batched",
                segment=100, retries=2, checkpoint=None, resume=False,
                max_lanes="auto", pids=None, _abort_after_segments=None,
                stats=None, _lane_offset=0, _point_keys=None,
                _check_all_periods=False):
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
      device:  where the sampler runs: one device (the card unless the
               caller asks for the CPU, which runs the kernels' plain
               versions), or a sequence of devices — the (point, chain)
               lanes split into contiguous ranges, one per entry (an
               entry may repeat), each run in a spawned process of its
               own; no lane is replicated.  Every lane's key follows its
               global index, so the tracks do not depend on the split.
      point_cls: Point subclass whose ``_misfit_from_c`` is the
               likelihood of every lane; default ``type(points[0])``,
               with a homogeneity check.
      sampler: "batched" (one batched solve a step, the kernels) or
               "legacy" (the JAX package's per-chain kernel, each
               chain's forward the single-model float64 solve; point
               ``k``'s chains take the keys ``split(fold_in(PRNGKey(
               seed), k), n_chains)``; no segments, no checkpoint).
      segment: run the chain in segments of this many steps (None = one
               piece).  Every step's draws are a pure function of (lane
               key, global step), so the tracks do not depend on it.
      retries: after a transient fault (see ``_transient``) roll back to
               the last committed segment and re-run from there, this
               many times.  The sampler is deterministic, so a retry
               continues the exact chain.
      checkpoint: optional path; after each committed segment the carry
               (each entry with its dtype) and the rows so far are
               written there atomically (``<checkpoint>.tmp.npz``, then
               ``os.replace``).  Tiles write ``<checkpoint>.tile{i}``,
               lane ranges ``<checkpoint>.range{j}``.
      resume:  True continues from ``checkpoint`` where it exists; the
               run configuration must match (else ``ValueError``), and
               the tracks equal those of the uninterrupted run.
      max_lanes: "auto" runs up to 8,192 (point, chain) lanes at once and
               tiles larger grids at 1,024 lanes; an integer tiles at
               that lane count; None never tiles.  Lane keys are offset
               per tile, so tiled and untiled runs give the same tracks.
      pids:    optional output basenames overriding ``lon_lat``.
      stats:   optional dict the call fills (tiles add up): the seconds
               of its phases (``setup``, ``segments``, ``write``);
               ``counters``, what :func:`..profiling.counters` counted
               over the call (it runs inside ``profiling.counting()``),
               the lane ranges' processes included: ``host_syncs`` (host
               reads of device values: the retry rounds' counts of
               unfound lanes, the prior's mantle count, the solve's
               ``ok.all()``, each segment's rows and carry to the host),
               ``propose.candidates`` (proposals the prior judged),
               ``compress.busy_s`` (the streamed compressor's
               worker-thread CPU seconds),
               ``solve.warm_fallbacks`` / ``solve.rescues``
               (solves whose warm window missed a lane / that ran the
               rescue pass) and ``kernel.<name>`` (secular-lane
               launches); and, for lane ranges, ``ranges``: each range's
               device, [lo, hi) lanes, seconds, the kernel launch counts
               and the ``counters`` of its process.

    Returns the list of written file paths.
    """
    from pysurfinv_tpu_torch.inversion import random as R
    from pysurfinv_tpu_torch.inversion.compiled import (BrownianSpec,
                                                        CompiledModel)
    from pysurfinv_tpu_torch.inversion.mcmc import ChainConfig

    if sampler not in ("batched", "legacy"):
        raise ValueError(f"invert_grid: unknown sampler {sampler!r} "
                         "(batched or legacy)")
    if priori and outdir.split("_")[-1] != "priori":
        outdir = "_".join((outdir, "priori"))
    devices = _devices(device)

    FALLBACK_LANES = 1024
    AUTO_CEILING = 8192
    nch = max(runN // chainL, 1)
    lane_limit = AUTO_CEILING if max_lanes == "auto" else max_lanes
    if (sampler == "batched" and lane_limit and len(points) > 1
            and len(points) * nch > lane_limit):
        per = max(1, (FALLBACK_LANES if max_lanes == "auto" else max_lanes)
                  // nch)
        paths = []
        for i in range(0, len(points), per):
            paths += invert_grid(
                points[i:i + per], lonlats[i:i + per], outdir=outdir,
                runN=runN, chainL=chainL, seed=seed, priori=priori,
                wave=wave, device=devices, verbose=verbose,
                point_cls=point_cls, segment=segment, retries=retries,
                checkpoint=f"{checkpoint}.tile{i}" if checkpoint else None,
                resume=resume, max_lanes=None,
                pids=pids[i:i + per] if pids else None,
                _abort_after_segments=_abort_after_segments, stats=stats,
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

    # ---- lanes: (point, chain), point-major, as host arrays -------------
    n_real = K * nch
    rep = lambda x: np.repeat(x, nch, axis=0)  # noqa: E731
    if sampler == "legacy":
        pkeys = (R.fold_in(R.PRNGKey(seed), torch.arange(K))
                 if _point_keys is None else torch.as_tensor(_point_keys))
        keys = R.split(pkeys, nch).reshape(n_real, 2)
    else:
        keys = R.fold_in(R.PRNGKey(seed),
                         torch.arange(n_real) + _lane_offset)
    cfg = ChainConfig(chain_len=chainL, priori=priori)
    job = dict(model=points[0].initMod, pcls=pcls, wave=wave, cfg=cfg,
               sampler=sampler, scfg=mcmc_solver_cfg(),
               spec=tuple(rep(f) for f in spec_np), psi=rep(psi_np),
               periods=rep(periods), obs_c=rep(obs_c), uncer=rep(uncer),
               obs_m=rep(obs_m), use_init=np.tile(np.arange(nch) == 0, K),
               keys=keys.numpy(), segment=segment, retries=retries,
               resume=resume, abort_after_segments=_abort_after_segments,
               verbose=verbose, check_all_periods=_check_all_periods,
               stream_npz=(sampler == "batched" and os.environ.get(
                   "PYSURFINV_STREAM_NPZ", "1") != "0"),
               ck_meta={"fmt": 3, "seed": seed + _lane_offset,
                        "runN": runN, "chainL": chainL, "K": K})
    job["count"] = stats is not None
    stats = {} if stats is None else stats
    t_init = time.time()
    with profiling.counting(job["count"]):
        before = profiling.counters()
        tracks_buf, lane_parts = _run_ranges(
            job, devices, checkpoint if sampler == "batched" else None,
            verbose, stats)
        t_run = time.time()
        paths = write_chain_files(points, lonlats, outdir, tracks_buf,
                                  chainL, lane_parts=lane_parts, pids=pids)
        _add(stats.setdefault("counters", {}),
             _delta(before, profiling.counters()))
    for k, sec in (("setup", t_init - t0), ("segments", t_run - t_init),
                   ("write", time.time() - t_run)):
        stats[k] = stats.get(k, 0.0) + sec
    if verbose:
        where = devices[0] if len(devices) == 1 else devices
        print(f"invert_grid: {K} points x {nch} chains x {chainL} steps "
              f"({sampler}) on {where}: setup {t_init - t0:.1f} s, "
              f"segments {t_run - t_init:.1f} s, write "
              f"{time.time() - t_run:.1f} s")
    return paths


def write_chain_files(points, lonlats, outdir, tracks, chainL,
                      lane_parts=None, pids=None):
    """Write one reference-format npz per point (``mcTrack``, ``setting``,
    ``obs``, ``invMeta``) from the lane-major ``tracks`` (K * n_chains,
    chainL, w), point-major lanes.

    With ``lane_parts`` (each lane's raw-deflate chunks, from
    :class:`..utils.StreamingLaneCompressor`) a point's ``mcTrack`` entry
    is assembled from its lanes' chunks without recompression; without,
    each file is written by ``savez_fast``.  Both load equal.  Files are
    written from a pool of 8 threads for more than 4 points (zlib
    releases the GIL).  Returns the paths.
    """
    from pysurfinv_tpu_torch.utils import (DEFLATE_TERMINATOR,
                                           deflate_bytes, npy_bytes,
                                           npy_header_bytes,
                                           write_npz_precompressed)
    K = len(points)
    nch = tracks.shape[0] // K
    os.makedirs(outdir, exist_ok=True)
    tracks = np.ascontiguousarray(tracks).reshape(K, nch * chainL, -1)
    if lane_parts is not None:
        import zlib
        hdr = npy_header_bytes(tracks.shape[1:], tracks.dtype)
        hobj = zlib.compressobj(1, zlib.DEFLATED, -15)
        hparts = [hobj.compress(hdr) + hobj.flush(zlib.Z_FULL_FLUSH)]
        raw_size = len(hdr) + tracks[0].nbytes

    def _write(k):
        lon, lat = lonlats[k]
        pid = pids[k] if pids else f"{lon:g}_{lat:g}"
        if lane_parts is None:
            return points[k]._save_npz(outdir, pid, tracks[k], chainL)
        path = f"{outdir}/{pid}.npz"
        lo = k * nch
        crc = zlib.crc32(tracks[k], zlib.crc32(hdr))
        entries = [("mcTrack", raw_size, crc,
                    hparts + [c for lane in lane_parts[lo:lo + nch]
                              for c in lane] + [DEFLATE_TERMINATOR])]
        meta = dict(setting=dict(points[k].initMod.toYML()),
                    obs=points[k].obs, invMeta={"pid": pid, "chainL": chainL})
        for name, val in meta.items():
            b = npy_bytes(val)
            c, parts = deflate_bytes(b)
            entries.append((name, len(b), c, parts))
        write_npz_precompressed(path, entries)
        return path

    with profiling.annotate("pysurfinv.write"):
        if K > 4:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=8) as pool:
                return list(pool.map(_write, range(K)))
        return [_write(k) for k in range(K)]

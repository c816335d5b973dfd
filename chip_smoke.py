#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's two main paths through the entry points a user calls:

  * the batched dispersion solve ``surf_forward_batch`` at the headline
    workload of bench.py: the 86-layer Cascadia-ocean model padded to
    L=88, built through the port's own model layer, 65,536 models
    (+-0.5% Vs/Vp jitter, seed 0), 18 periods, Rayleigh and Love, the
    MCMC sampler's warm re-solve, and the refinement in one
    ``refine_lanes`` call (``nnewton=2``, ``fuse_illinois``);
  * the joint Rayleigh + Love solve ``surf_forward_joint`` on that
    batch (Love cold, a 512-model Rayleigh calibration, the Rayleigh
    solve seeded from the Love roots), the single-model float64 solve
    ``surf_forward`` with an overtone, ``surf_ellipticity`` /
    ``surf_amplitude`` and the host inversion surface built on them
    (``Model1D.forward``, ``PointCascadia.misfit``, ``Point.MCinv``,
    ``PostPoint``);
  * the analysis surface in float64 (no kernel): ``sensitivity_kernels``,
    ``eigenfunctions_regular``, ``energy_integrals``,
    ``kernel_densities`` and the classes ``SensKernel`` /
    ``SensKernelPert`` on the TEST1 model;
  * the batched MCMC sampler ``invert_grid`` at the JAX package's
    flagship workload (bench.py:249-260): 64 PointCascadia points of the
    reference's example setting (examples/invert_point.py:21-51),
    sedthk and lithoAge from default_rng(0), 30 chains a point (1,920
    lanes), 18 periods, seed 1, the depth cut to chainL 100 (runN 3000,
    segment 50; the workload's chainL is 200) — with the default
    solver (newton_sep 3), checkpointed and resumed, split into two lane
    ranges, and with ``PYSURFINV_MCMC_NNEWTON=2``; the streamed npz
    writer and the posterior comparator on its files;
  * the per-chain legacy sampler, and the 3-D host analysis ``Model3D``
    (maps, profiles, sections, smoothing, phase-velocity QC) on the
    flagship run's 64 files;
  * the experimental samplers ``adaptive_point``, ``tuned_rwm_point``
    and ``mala_point`` (with its likelihood gradient) on the example
    point, and the single-model solve on the tree-product secular
    functions.

Phases, each of which raises on failure:

  1. card     the card's name and power limit (nvidia-smi) — no CPU
              fallback: without CUDA the script exits non-zero;
  2. build    the four secular-lane kernels (refine_lanes as its two
              phase kernels), built with nvcc from csrc/, with each
              kernel's registers and spills from ptxas;
  3. kernels  each kernel against its plain PyTorch version on the card,
              at main-path lane shapes (K=33 cold sweep, K=18 refinement
              and tangents, B=4096): |dF| <= 1e-4 * max_k |F| per model
              column, F_T/F_c to 2e-3 relative, b_hs and mm equal on
              >= 99.99% of lanes; refine_lanes on brackets from a sweep
              around each lane's root, n_newton 2 (with u) and 0 (the
              fuse_illinois form): |droot| <= 1e-4 km/s on >= 99.99% of
              lanes, u within 1e-3 relative at q99; every kernel must be
              bitwise equal to its plain version, there and at ragged
              shapes (B=4095; secular_lanes dynamic and pinned and
              secular_lanes_grad at K=1, 13 and 90; secular_lanes_frozen
              pinned and refine_lanes with n_newton 0, 1 and 2, u on and
              off, at K=1, 13 and 18);
  3b. draws   the sampler's draw kernels (ops/draw_lanes.py, built into
              their own library at the first CUDA key drawn from) against
              their plain torch ops on the card, bit for bit, every launch
              count set to 0 just before and checked after: a retry round
              (draw_round) at each stage of the survey sampler's retry
              pyramid (1,920 lanes x 1 draw down to 60 lanes x 34 draws,
              P of the example point), wholly perturbing, straddling
              n_perturb_rounds and wholly resetting; the step keys'
              fold_in, the acceptance draw's uniform, the legacy
              sampler's split(keys, chainL - 1) and the adaptive
              sampler's normal; each call's time (CUDA events) beside its
              plain ops';
  3c. prior   the prior (CompiledModel.isgood) replayed from its CUDA
              graphs against its plain torch ops on the card, bit for
              bit, at the survey sampler's two batch shapes (1,920 and
              2,040 rows of the flagship's 64 points, thetas over their
              bounds widened by a quarter), float64 and float32: two
              batches, then the first again (a stale input buffer would
              show), one capture a shape and replays only; each call's
              time (CUDA events) beside its plain ops';
  4. slice    the solve for Rayleigh (bench config), Love (nbisect 6), a
              warm Rayleigh re-solve with the sampler's settings
              (newton_sep=3) seeded with the Rayleigh roots, and Rayleigh
              with nnewton=2 and with fuse_illinois; every kernel's launch
              count must move; ok >= 0.999 per run, 0 < c < 5 km/s; on
              the first 1024 models the kernel path agrees with the
              plain path (ok on >= 99.9% of lanes, |dc| <= 1e-4 km/s);
              the refine_lanes runs agree with the default path
              (|dc| <= 1e-4 km/s on >= 99.9% of lanes); the TEST1 golden
              curve (tests/golden/test1.npz) to 1e-4;
  4b. joint   surf_forward_joint on the phase-4 batch (cfg of the Rayleigh
              and Love runs, nsub 512): its Love outputs bit for bit phase
              4's Love solve, its Rayleigh ok on >= 0.999 of curves,
              |dc| <= 1e-4 km/s against phase 4's Rayleigh solve on >=
              99.9% of lanes, ok agreement >= 0.999, the launch counts of
              secular_lanes, secular_lanes_frozen and secular_lanes_grad
              moved; then, float64 on the card, the single-model
              surf_forward on the TEST1 eus model (nmodes 2, Rayleigh and
              Love) to the golden tolerances of
              tests/test_dispersion_golden.py and on the bench batch's
              first model against the kernel solve (|dc| <= 1e-4 km/s),
              with its seconds per curve; surf_ellipticity on a uniform
              Poisson halfspace (c = 0.9194 beta to 2e-3, H/V flat to
              1e-3 and within 0.02 of 0.681) and surf_amplitude on TEST1
              (finite, positive where solved); Model1D.forward and
              PointCascadia.misfit on the reference's example point,
              Point.MCinv (runN 4, chainL 2, 5 periods) writing an npz
              with finite misfits, and PostPoint loading it;
  4c. analysis float64 on the card, the TEST1 eus model: sensitivity_kernels
              (Rayleigh and Love, nbisect 30, group, T = 10/30/60 s)
              against central finite differences of surf_forward at layers
              5/17/30/50 (2e-5 of scale for phase, 3e-3 for group) and
              against the same call on CPU tensors (1e-9 of each field's
              max, 1e-8 for the group kernels), q_app against the TEST1
              .att golden (2e-2), nmodes 2 once a wave;
              eigenfunctions_regular and energy_integrals (nmodes 2, the 10
              golden periods, at the golden header roots) against the
              TEST1 depth tables, integrals, group and variational phase
              velocities, and kernel_densities(group=True) against the
              density tables, with the tolerances and exclusions of
              tests/test_eigen.py and tests/test_kernel_density_golden.py;
              SensKernel "ad" and "eigen" (68 layers, T 10-60 s, endmode 1)
              and SensKernelPert (the first 12 layers) on a dict model,
              finite where solved; the seconds of each call;
  5. sampler  on 2 points x 4 chains x 6 steps the sampler with the
              kernels gives the tracks of the sampler with the plain
              versions (the solve's and the draws'); then the flagship workload four times, each run
              with every launch count set to 0 just before it: the first
              call checkpointed and killed after its first segment, then
              resumed from the checkpoint (the seconds of each half and
              the checkpoint's size printed); the timed call with the
              default solver (mcmc_effective_solves_per_sec = 64 * 3000 /
              seconds), whose tracks the resumed run must equal bit for
              bit and whose files are written by the streamed writer; the
              lanes split into two ranges on ``["cuda:0", "cuda:0"]``,
              one spawned process each (the kernel launches counted in
              the ranges' processes), tracks bit for bit the timed
              call's; and PYSURFINV_MCMC_NNEWTON=2 (NEWTON_SEP=0, which
              the variable needs to take effect): every npz written,
              every misfit finite, the acceptance rate printed, the
              expected launch counters moved; the timed call's 64 files
              rewritten by the savez_fast path load equal, array by
              array (both write times printed); the posterior comparator
              on the timed and nnewton2 runs (every z-score finite; the
              p-value printed, not gated); a torch.profiler trace (CUDA
              activity) of a 6-row run gives the device idle share;
  5b. survey  the legacy sampler (Point.MCinvMP(sampler="legacy"), 1 point
              x 2 chains x 4 steps, 5 periods) on the card against the
              same call on CPU tensors (accepts equal, thetas to 1e-10,
              misfits to 1e-9 relative); Model3D on the timed run's 64 files on
              the card: all 64 points loaded, genVsMap(50) finite on all
              64 nodes, vsProfile and a section, smooth and smoothGrid
              against the same calls with CPU tensors (1e-12 of each
              field's max), checkPhaseVelocity(pers=[10, 50]), write /
              load; the seconds of each step;
  5c. exp.    the experimental samplers on the reference's example point:
              at 2 lanes x 6 rows (the solver's separated Newton cut to
              1 iteration), adaptive_point, tuned_rwm_point and
              mala_point each give the same tracks with the kernels as
              with the plain versions (the solve's and the draws'), bit
              for bit; then each at the
              default lane count of its entry point, depth cut (AM: 6
              lanes, warmups 64/128/64, chainL 200; tuned RWM: 48 warm
              lanes, std_steps 128, rm_steps 32, 6 recorded lanes x 200;
              MALA: 30 lanes x 50, tau 0.8), every launch count set to 0
              just before and read just after (secular_lanes, frozen and
              gradient must move): row 0 of every chain accepted, every
              value finite, acceptance in (0, 1] (above 0.05 for MALA),
              the AM Cholesky factor lower-triangular with a positive
              diagonal, PostPoint reads the file; seconds, steps/s and
              MALA's solve and gradient shares of a step (synchronised
              host clock); the MALA gradient on the card against the CPU
              (4 lanes, float64, 1e-9 of each lane's max); the
              single-model float64 solve on the tree-product secular
              functions (SurfConfig(backend="xla_assoc")) on bench model 0,
              Rayleigh and Love, within 5e-5 km/s of the sequential
              solve, seconds per curve of both;
  6. time     solves/s per run and the joint solve's R+L curve pairs/s
              beside the independent Rayleigh + Love solves, each
              kernel's time beside its plain
              version's and its bound, and at the sampler's size (B=1,920,
              K=18; K=90 for secular_lanes, the fused warm sweep),
              refine_lanes with n_newton 2 beside the separate frozen +
              gradient launches it replaces and with n_newton 0 beside the
              separate Illinois frozen launches (CUDA events for kernels,
              best of 3 windows after a warm-up, the plain versions one
              call each; host clock around synchronised solves); the
              seconds each phase took.

Prints the card line and a JSON line of per-kernel results before the
last line, ``{"ok": true, "device": {...}}``.  Run from the repository
root: ``python3 chip_smoke.py``; it takes about fourteen minutes on an
H100, most of them in the sampler's host-bound runs, Model3D's 128
single-model float64 solves, the plain versions' timings and sampler
runs (phases 3, 5 and 5c), and the analysis phase's eager float64 calls
(~1 minute).
"""

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PERIODS = [10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40, 50, 60,
           70, 80]
B_SLICE = 65536
B_LANES = 4096
B_PLAIN = 1024
DC = 0.01
BENCH_SETTING = {
    "OceanWater": {"H": 2},
    "OceanSedimentCascadia": {"H": 0.5},
    "OceanCrust": {"H": 7, "Vs": [3.25, 3.94]},
    "OceanMantleHybrid": {
        "BottomDepth": 200, "Conversion": "Ritzwoller", "ThermAge": 4.0,
        "Vs": [[0.02, "fixed"], [0.01, "fixed"],
               [-0.01, "fixed"], [-0.02, "fixed"]],
    },
    "Info": {"modelType": "CascadiaOcean", "period": 10,
             "refLayer": True, "lithoAgeQ": True},
}
# the reference's example point (examples/invert_point.py:21-51)
MC_SETTING = {
    "OceanWater": {"H": 2},
    "OceanSedimentCascadia": {"H": [1, "rel_pos", 100, 0.1]},
    "OceanCrust": {"H": 7, "Vs": [3.25, 3.94]},
    "OceanMantleHybrid": {
        "BottomDepth": 200, "Conversion": "Ritzwoller",
        "ThermAge": [4, "rel_pos", 200, 0.4],
        "Vs": [[0, "abs", 0.4, 0.01], [0, "abs", 0.4, 0.01],
               [0, "abs", 0.4, 0.01], [0, "abs", 0.2, 0.01]],
    },
    "Info": {"modelType": "CascadiaOcean", "period": 10,
             "refLayer": True, "lithoAgeQ": True},
}
MC_LOCAL = {
    "topo": -2.567706, "lithoAge": 0.6, "sedthk": 0.019,
    "mantleInitParmVs": [-0.3426920324186606, -0.1863907997418917,
                         -0.1882828662382096, -0.05648363217566826],
}
MC_VELS = [3.5724066175576223, 3.6222019289297043, 3.6520621581430763,
           3.6588731735179367, 3.673255450218663, 3.683443600610537,
           3.6844591498161896, 3.689993791502759, 3.6935745493241487,
           3.696092260762209, 3.707185398688356, 3.7148258328900985,
           3.7209668755498257, 3.7486729577980427, 3.7706463827824748,
           3.82144353111797, 3.8603954933518914, 3.9030011211762767]
MC_UNCERS = [0.006550350458769691, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005,
             0.005, 0.005, 0.005, 0.005, 0.005499996722895128,
             0.00751713560920708, 0.007910350806141024, 0.007711019920661203,
             0.010152973423528881, 0.01062776863809981, 0.015829560954127662]
# chain depth cut to 100 (bench.py's 200) to keep the smoke's time
MC_POINTS, MC_RUN_N, MC_CHAIN_L, MC_SEGMENT, MC_SEED = 64, 3000, 100, 50, 1
B_SAMPLER = MC_POINTS * (MC_RUN_N // MC_CHAIN_L)  # the sampler's 1,920 lanes

KERNEL_SOURCE = "pysurfinv_tpu_torch/csrc/secular_lanes.cu"
REPLACES = {
    "secular_lanes": "pysurfinv_tpu/ops/pallas_secular.py:843",
    "secular_lanes_frozen": "pysurfinv_tpu/ops/pallas_secular.py:1115",
    "secular_lanes_grad": "pysurfinv_tpu/ops/pallas_secular.py:779",
    "refine_lanes": "pysurfinv_tpu/ops/pallas_secular.py:1030",
}

# ---- the least time the card could take (bound_ms) ----------------------
# The H100 SXM's published peaks (NVIDIA data sheet, at 700 W): 3.35 TB/s
# of HBM and 67 TFLOP/s of FP32 outside the tensor cores.  Operations are
# counted off csrc/secular_lane.cuh per applied layer step of one lane:
# every FP32 +, -, *, / and each expf/sincosf half/sqrtf/logf as one,
# with the evanescent side of each regime (the side most applied layers
# take here) and without the loop-invariant c*c and 2 pi / (c T): the
# layer's material 12, the wavenumbers 12, two pq regimes 18, the Dunkin
# matrix and 5-vector update 127, the renormalisation 11 -> 182 for
# Rayleigh; the Haskell pair 24 + material 12 + renormalisation 5 -> 41
# for Love; the dynamic walk adds 3 (Rayleigh) or a second material read
# and its sum, 15 (Love), per layer.  The gradient's dual numbers carry
# two tangents, counted as 4x.  A lane applies the layers above its
# closure (mm - 1 of them, from the launch's own mm), so the count
# follows the data of this run.  Bytes: every input read once, every
# output written once.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_LAYER = {"rayleigh": 182, "love": 41}
WALK_OPS_PER_LAYER = {"rayleigh": 3, "love": 15}
DUAL_FACTOR = 4
# the kernels' symbols in the ptxas report (refine_lanes launches two, one
# a phase), and the H100's register file (65,536 a SM, allocated 256 a
# warp; at most 64 warps and 32 blocks a SM)
PTXAS_NAMES = {"secular_lanes": "secular_lanes_kernel",
               "secular_lanes_frozen": "secular_frozen_kernel",
               "secular_lanes_grad": "secular_grad_kernel",
               "refine_lanes_illinois": "refine_illinois_kernel",
               "refine_lanes_newton": "refine_newton_kernel"}
PHASES = {"refine_lanes": ("illinois", "newton")}
BLOCK = 128


def bound(nbytes, ops):
    """(bound_ms, bound_by) of a launch that moves ``nbytes`` and does
    ``ops`` operations."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ptxas_usage(report, names=PTXAS_NAMES):
    """{(kernel, wave): (registers, spill-store bytes)} from nvcc's
    ``-Xptxas -v`` report (template argument true = Rayleigh) for the
    kernels ``names`` maps to their symbols."""
    usage, name, spill = {}, None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = None
            for k, sym in names.items():
                for flag, wave in (("ILb1", "rayleigh"), ("ILb0", "love")):
                    if sym + flag in line:
                        name = (k, wave)
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes stack frame,")[1].split()[0])
        elif "Used" in line and "registers" in line and name:
            usage[name] = (int(line.split("Used")[1].split()[0]), spill)
            name = None
    return usage


def occupancy(registers, threads=BLOCK):
    """Theoretical occupancy (resident warps over 64) of a kernel with
    ``registers`` a thread in blocks of ``threads``, by registers alone."""
    warps = threads // 32
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(32, 65536 // (per_warp * warps), 64 // warps)
    return blocks * warps / 64


def warm_sweep(root, tk):
    """The sampler's fused warm sweep (ops/dispersion.py:340-352 with its
    settings nscan 32, coarse 8, backoff 12, dc 0.01): 5 trial c a
    period from 0.12 km/s below each root, (18 x 5, B) lanes."""
    import torch
    ladder = 0.08 * torch.arange(5, device=root.device, dtype=root.dtype)
    P, B = root.shape
    cs = ((root - 0.12)[:, None, :] + ladder[None, :, None]).reshape(-1, B)
    return (cs.contiguous(),
            tk[:, None, :].expand(P, 5, B).reshape(-1, B).contiguous())


def bitwise(a, b):
    """Every output of a kernel (a tensor or a tuple of them) bit for bit
    equal to its plain version's."""
    import torch
    a, b = ((x,) if torch.is_tensor(x) else x for x in (a, b))
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


@contextlib.contextmanager
def draws_on(backend):
    """The sampler's draws on ``backend``.  They dispatch on the keys'
    device, not on the solver's ``backend``: under "auto" they launch the
    draw kernels on the card; "plain" forces the torch ops of the three
    stream primitives and of the retry round."""
    from unittest import mock

    from pysurfinv_tpu_torch.inversion import mcmc
    from pysurfinv_tpu_torch.inversion import random as R
    with contextlib.ExitStack() as stack:
        if backend == "plain":
            for mod, name in ((R, "fold_in"), (R, "split"),
                              (R, "random_bits"), (mcmc, "_draw_round")):
                stack.enter_context(mock.patch.object(
                    mod, name, functools.partial(getattr(mod, name),
                                                 backend="plain")))
        yield


def bench_batch(B, seed):
    """bench.py:31-67 through the port's model layer: (B, 5, L) float32
    batch of h, vp, vs, rho, qsinv, and the real-layer count."""
    from pysurfinv_tpu_torch.models.model1d import buildModel1D, padded_profile

    mod = buildModel1D(BENCH_SETTING,
                       {"topo": -2, "sedthk": 0.5, "lithoAge": 4.0})
    h, vs, vp, rho, qs, _, _ = mod.seisPropLayers(refLayer=True)
    nlay = int(np.sum(h > 1e-3))
    L = int(-(-(nlay + 1) // 8) * 8)
    H, VP, VS, RHO, QSI, nlay = padded_profile(h, vs, vp, rho, qs, L=L)
    base = np.stack([H, VP, VS, RHO, QSI])
    batch = np.repeat(base[None], B, axis=0)
    jit = 1.0 + 0.005 * np.random.default_rng(seed).standard_normal((B, L))
    batch[:, 2] *= np.where(base[0] > 0, jit, 1.0)
    batch[:, 1] *= np.where(base[0] > 0, jit, 1.0)
    return batch.astype(np.float32), nlay


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_cuda(fn, n=5, windows=3, warm=1):
    """Best per-call milliseconds over ``windows`` windows of ``n`` calls,
    timed with CUDA events after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(windows):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / n)
    return best


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "the port's smoke test needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from pysurfinv_tpu_torch.convert import model_batch_from_numpy
    from pysurfinv_tpu_torch.ops import draw_lanes as DL
    from pysurfinv_tpu_torch.ops import secular_lanes as sl
    from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _illinois,
                                                    _initial_c,
                                                    surf_forward_batch,
                                                    surf_forward_joint)
    from pysurfinv_tpu_torch.ops.flatten import flatten_factors

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card -----------------------------------------------------
    card = card_line()
    log(card)
    log(f"[card] torch.cuda.get_device_name(0) = {kind}; "
        f"nvidia-smi name, power.limit = {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    _, info = sl.kernel_library()
    build_s = time.perf_counter() - t0
    log(f"[build] secular-lane kernels: nvcc {info['seconds']:.1f} s, "
        f"load total {build_s:.1f} s ({card})")
    usage = ptxas_usage(info["log"])
    for (name, wave), (regs, spill) in sorted(usage.items()):
        log(f"[build]  {name} {wave}: {regs} registers, {spill} bytes spill "
            f"stores, theoretical occupancy {occupancy(regs):.4f} "
            f"(blocks of {BLOCK})")
    check(len(usage) == 2 * len(PTXAS_NAMES),
          f"ptxas report lists {sorted(usage)}, not every kernel")

    # ---- model -------------------------------------------------------
    batch, nlay = bench_batch(B_SLICE, seed=0)
    L = batch.shape[2]
    log(f"[model] bench Cascadia-ocean model: {nlay} layers, L={L}, "
        f"B={B_SLICE}")
    *arrs, nl = model_batch_from_numpy(*batch.transpose(1, 0, 2), nlay,
                                       device=dev)
    periods = torch.tensor(PERIODS, dtype=torch.float32, device=dev)
    cfg_r = SurfConfig(nmodes=1, nscan_first=512, nscan=12, nbisect=8,
                       warm_backoff=4, coarse_first=16)
    cfg_l = replace(cfg_r, nbisect=6)
    cfg_s = SurfConfig(nmodes=1, compute_group=False, nscan=32,
                       warm_backoff=12, nbisect=11, coarse=8, newton_sep=3,
                       coarse_first=8)
    cfg_n = replace(cfg_r, nnewton=2)
    cfg_f = replace(cfg_r, fuse_illinois=True)
    waves = {"rayleigh": cfg_r, "love": cfg_l}

    def lane_model(sub, nlb, wave):
        fac = flatten_factors(sub[0], nlb, 1 if wave == "love" else 2)
        return [x.T.contiguous() for x in (*sub[1:], *fac)]

    phase_s = {}

    def mark(phase):
        """Seconds since the previous mark go to ``phase``."""
        phase_s[phase] = time.perf_counter() - t_start - sum(phase_s.values())

    mark("card+build")
    # ---- 3. kernels against their plain versions ---------------------
    kerr = {k: {"max_abs_err": 0.0} for k in REPLACES}
    bits = {k: {} for k in REPLACES}
    for wave, cfg in waves.items():
        sub = [a[:B_LANES] for a in arrs]
        nlb = nl[:B_LANES]
        model = lane_model(sub, nlb, wave)
        c_init = _initial_c(sub[0], sub[2], sub[4], nlb,
                            periods[0].expand(B_LANES), wave, cfg)
        cs = (c_init[None] + cfg.coarse_first * DC
              * torch.arange(33, device=dev, dtype=torch.float32)[:, None])
        ts = periods[0].expand(cs.shape).contiguous()
        mm0 = torch.zeros(cs.shape, dtype=torch.int32, device=dev)
        k1 = sl.secular_lanes(cs, ts, mm0, *model, nlb, wave=wave)
        p1 = sl.secular_lanes(cs, ts, mm0, *model, nlb, wave=wave,
                              backend="plain")
        torch.cuda.synchronize()
        same = (k1[2] == p1[2]) & torch.isclose(k1[1], p1[1], rtol=1e-6,
                                                atol=0)
        frac = float(same.float().mean())
        check(frac >= 0.9999, f"{wave} secular_lanes b_hs/mm agree on "
              f"{frac:.6f} of lanes")
        e1 = compare_F(k1[0], p1[0], same, f"{wave} secular_lanes")
        bits["secular_lanes"][wave] = bitwise(k1, p1)

        # K=18 refinement lanes: the roots of a kernel solve, +-0.17 km/s
        # apart across periods for F, at the roots for F_T/F_c
        root, _, ok = surf_forward_batch(*sub, periods, nlb, wave=wave,
                                         cfg=cfg)
        root = torch.where(ok, root, 3.5)[:, :, 0].T.contiguous()
        tk = periods[:, None].expand(root.shape).contiguous()
        _, _, mm = sl.secular_lanes(root + DC, tk, torch.zeros_like(mm0[:18]),
                                    *model, nlb, wave=wave, backend="plain")
        off = root + 0.02 * (torch.arange(18, device=dev)[:, None] - 8.5)
        k2 = sl.secular_lanes_frozen(off, tk, mm, *model, nlb, wave=wave)
        p2 = sl.secular_lanes_frozen(off, tk, mm, *model, nlb, wave=wave,
                                     backend="plain")
        e2 = compare_F(k2, p2, None, f"{wave} secular_lanes_frozen")
        bits["secular_lanes_frozen"][wave] = bitwise(k2, p2)
        k3 = sl.secular_lanes_grad(off, tk, mm, *model, nlb, wave=wave)
        p3 = sl.secular_lanes_grad(off, tk, mm, *model, nlb, wave=wave,
                                   backend="plain")
        e3 = compare_F(k3[0], p3[0], None, f"{wave} secular_lanes_grad")
        k3r = sl.secular_lanes_grad(root, tk, mm, *model, nlb, wave=wave)
        p3r = sl.secular_lanes_grad(root, tk, mm, *model, nlb, wave=wave,
                                    backend="plain")
        torch.cuda.synchronize()
        bits["secular_lanes_grad"][wave] = (bitwise(k3, p3)
                                            and bitwise(k3r, p3r))
        for name in ("secular_lanes", "secular_lanes_frozen",
                     "secular_lanes_grad"):
            check(bits[name][wave], f"{wave} {name} is not bitwise equal to "
                  "its plain version")
        rk, rp = k3r[2] / k3r[1], p3r[2] / p3r[1]
        rerr = float(((rk - rp).abs()
                      / torch.clamp(rp.abs(), min=1e-6)).max())
        check(rerr <= 2e-3, f"{wave} secular_lanes_grad F_T/F_c relative "
              f"error {rerr:.3e} > 2e-3")
        log(f"[kernels] {wave}: secular_lanes max|dF| {e1:.3e} (b_hs/mm "
            f"agree {frac:.6f}); secular_lanes_frozen max|dF| {e2:.3e}; "
            f"secular_lanes_grad max|dF| {e3:.3e}, F_T/F_c max rel err "
            f"{rerr:.3e}; bitwise equal to the plain versions: "
            f"secular_lanes {bits['secular_lanes'][wave]}, "
            f"secular_lanes_frozen {bits['secular_lanes_frozen'][wave]}, "
            f"secular_lanes_grad {bits['secular_lanes_grad'][wave]} "
            f"({card})")
        for name, e in (("secular_lanes", e1), ("secular_lanes_frozen", e2),
                        ("secular_lanes_grad", e3)):
            kerr[name]["max_abs_err"] = max(kerr[name]["max_abs_err"], e)
        kerr["secular_lanes_grad"]["ratio_rel_err_" + wave] = rerr
        kerr["secular_lanes"]["lanes_agree_" + wave] = frac

        # refine_lanes on brackets from a real sweep: 0.01 km/s rungs
        # from 0.1 km/s below each lane's root, first sign change
        lo, hi, mmb = sweep_brackets(sl, root, tk, model, nlb, wave)
        for n_newton, group in ((2, True), (0, False)):
            kr = sl.refine_lanes(lo, hi, tk, mmb, *model, nlb, wave=wave,
                                 n_ill=cfg.nbisect, n_newton=n_newton,
                                 compute_group=group)
            pr = sl.refine_lanes(lo, hi, tk, mmb, *model, nlb, wave=wave,
                                 n_ill=cfg.nbisect, n_newton=n_newton,
                                 compute_group=group, backend="plain")
            torch.cuda.synchronize()
            d = (kr[0] - pr[0]).abs()
            within = float((d <= 1e-4).float().mean())
            check(within >= 0.9999, f"{wave} refine_lanes n_newton="
                  f"{n_newton}: |droot| <= 1e-4 on {within:.6f} of lanes")
            same_bits = bitwise(kr, pr)
            check(same_bits, f"{wave} refine_lanes n_newton={n_newton} is "
                  "not bitwise equal to its plain version")
            uq = 0.0
            if group:
                urel = ((kr[1] - pr[1]).abs()
                        / torch.clamp(pr[1].abs(), min=1e-6)).double()
                uq = float(torch.quantile(urel, 0.99))
                check(uq <= 1e-3, f"{wave} refine_lanes u q99 relative "
                      f"error {uq:.3e} > 1e-3")
            inside = float(((kr[0] >= lo) & (kr[0] <= hi)).float().mean())
            log(f"[kernels] {wave}: refine_lanes K=18 B={B_LANES} "
                f"n_ill={cfg.nbisect} n_newton={n_newton}: bitwise "
                f"{same_bits}, max|droot| {float(d.max()):.3e} km/s, q99 "
                f"u rel {uq:.3e}, roots inside their bracket {inside:.6f} "
                f"({card})")
            kerr["refine_lanes"]["max_abs_err"] = max(
                kerr["refine_lanes"]["max_abs_err"], float(d.max()))
            kerr["refine_lanes"][f"bitwise_{wave}_nnewton{n_newton}"] = \
                same_bits
            bits["refine_lanes"][wave] = (bits["refine_lanes"].get(wave, True)
                                          and same_bits)
        ragged_check(sl, [a[:B_LANES - 1] for a in arrs], nl[:B_LANES - 1],
                     root[:, :B_LANES - 1].contiguous(),
                     tk[:, :B_LANES - 1].contiguous(), wave, cfg.nbisect,
                     lane_model, card)

    mark("kernels")
    # ---- 3b. the draw kernels against their plain versions -------------
    launches_draw, draws = draw_phase(dev, card)
    mark("draws")
    # ---- 3c. the prior's CUDA graphs against its plain ops ---------------
    prior = prior_phase(card)
    mark("prior")
    # ---- 4. the solve ------------------------------------------------
    sl.reset_launch_counts()
    out_r = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_r)
    out_l = surf_forward_batch(*arrs, periods, nl, wave="love", cfg=cfg_l)
    c_warm = out_r[0][:, :, 0]
    out_s = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_s, c_warm=c_warm)
    out_n = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_n)
    n_refine = sl.refine_lanes.launches
    out_f = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_f)
    torch.cuda.synchronize()
    # refine_lanes calls with n_newton 0: the fuse_illinois solve's
    launches_nnewton0 = sl.refine_lanes.launches - n_refine
    launches_solve = {k.__name__: k.launches for k in sl.KERNELS}
    log(f"[slice] kernel launches in the solve path's run: "
        f"{launches_solve}")
    for name, n in launches_solve.items():
        check(n > 0, f"{name} was not launched on the solve path")

    runs = {"rayleigh": (out_r, cfg_r, None),
            "love": (out_l, cfg_l, None),
            "rayleigh_warm_sampler": (out_s, cfg_s, c_warm),
            "rayleigh_nnewton2": (out_n, cfg_n, None),
            "rayleigh_fuse_illinois": (out_f, cfg_f, None)}
    for name, (out, cfg, cw) in runs.items():
        c, u, ok = out
        check(tuple(c.shape) == (B_SLICE, len(PERIODS), 1),
              f"{name} output shape {tuple(c.shape)}")
        ok_curve = float(ok[:, :, 0].all(dim=1).float().mean())
        ok_lane = float(ok.float().mean())
        check(ok_curve >= 0.999, f"{name} ok fraction {ok_curve:.5f} < 0.999")
        cv = c[ok]
        check(bool(torch.isfinite(cv).all()) and float(cv.min()) > 0
              and float(cv.max()) < 5, f"{name} c outside (0, 5) km/s")
        if cfg.compute_group:
            # the float32 group velocity has a tail of ill-conditioned
            # lanes (F_T/F_c at the f32 noise floor); count it
            uv = u[ok]
            good = torch.isfinite(uv) & (uv > 0) & (uv < 5)
            u_in = float(good.float().mean())
            log(f"[slice] {name}: u in (0, 5) km/s on {u_in:.6f} of ok "
                f"lanes ({int((~good).sum())} outside: "
                f"{uv[~good][:6].tolist()})")
            check(u_in >= 0.999, f"{name} u in (0, 5) km/s on only "
                  f"{u_in:.6f} of ok lanes")
        if name.startswith(("rayleigh_nnewton", "rayleigh_fuse")):
            # the refinement in one refine_lanes launch against the
            # default path's separate launches, every model
            both = ok & out_r[2]
            agree = float((ok == out_r[2]).float().mean())
            close = float(((c - out_r[0]).abs() <= 1e-4)[both].float()
                          .mean())
            check(close >= 0.999 and agree >= 0.999,
                  f"{name}: |dc| <= 1e-4 vs the default path on "
                  f"{close:.6f} of lanes, ok agree {agree:.6f}")
            log(f"[slice] {name}: ok {ok_curve:.5f} of curves; vs the "
                f"default path: ok agree {agree:.6f}, |dc| <= 1e-4 km/s on "
                f"{close:.6f} of lanes, max|dc| "
                f"{float((c - out_r[0]).abs()[both].max()):.3e} ({card})")
            continue
        # the same models through the plain versions on the card
        cp, up, okp = surf_forward_batch(
            *[a[:B_PLAIN] for a in arrs], periods, nl[:B_PLAIN],
            wave="love" if name == "love" else "rayleigh",
            cfg=replace(cfg, backend="plain"),
            c_warm=None if cw is None else cw[:B_PLAIN])
        ck, uk, okk = c[:B_PLAIN], u[:B_PLAIN], ok[:B_PLAIN]
        agree = float((okk == okp).float().mean())
        both = okk & okp
        dc_max = float((ck - cp)[both].abs().max())
        du_q99 = float(torch.quantile((uk - up)[both].abs().double(), 0.99))
        check(agree >= 0.999, f"{name} ok agreement with plain {agree:.5f}")
        check(dc_max <= 1e-4, f"{name} |dc| vs plain {dc_max:.3e} > 1e-4")
        log(f"[slice] {name}: ok {ok_curve:.5f} of curves ({ok_lane:.6f} of "
            f"lanes), c in [{float(cv.min()):.4f}, {float(cv.max()):.4f}] "
            f"km/s; vs plain on {B_PLAIN} models: ok agree {agree:.5f}, "
            f"max|dc| {dc_max:.3e} km/s, q99|du| {du_q99:.3e} km/s ({card})")

    golden_check(surf_forward_batch, SurfConfig, dev, card)

    mark("slice")
    # ---- 4b. the joint solve, the single-model solve, the host surface -
    launches_joint = joint_phase(sl, surf_forward_joint, arrs, periods, nl,
                                 cfg_r, cfg_l, out_r, out_l, card)
    mark("joint")
    single = single_model_phase(arrs, nl, periods, out_r, dev, card)
    mark("single+host")
    # ---- 4c. the analysis surface --------------------------------------
    analysis = analysis_phase(dev, card)
    mark("analysis")
    # ---- 5. the sampler ----------------------------------------------
    launches_mc, mc, mc_dir = sampler_phase(sl, card)
    mark("sampler")
    # ---- 5b. the legacy sampler and the 3-D host analysis -------------
    mc["legacy"] = legacy_check(dev, card)
    mark("legacy")
    mc["model3d"] = model3d_phase(mc_dir, dev, card)
    mark("model3d")
    # ---- 5c. the experimental samplers and the tree-product solve -----
    launches_exp, exp = experimental_phase(sl, arrs, nl, periods, dev, card)
    mark("experimental")

    # ---- 6. time -----------------------------------------------------
    solves, solve_ms = {}, {}
    for name, (_, cfg, cw) in runs.items():
        wave = "love" if name == "love" else "rayleigh"

        def solve():
            return surf_forward_batch(*arrs, periods, nl, wave=wave, cfg=cfg,
                                      c_warm=cw)

        solve()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(2):
                solve()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / 2)
        solves[name] = B_SLICE / best
        solve_ms[name] = best * 1e3
        log(f"[time] {name}: {best * 1e3:.2f} ms per {B_SLICE}-model "
            f"18-period solve, {B_SLICE / best:.1f} solves/s ({card})")

    def joint():
        return surf_forward_joint(*arrs, periods, nl, cfg=cfg_r,
                                  cfg_love=cfg_l, nsub=512)

    joint()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(2):
            joint()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / 2)
    solves["joint_rl"] = B_SLICE / best
    solve_ms["joint_rl"] = best * 1e3
    indep = solve_ms["rayleigh"] + solve_ms["love"]
    log(f"[time] joint_rl: {best * 1e3:.2f} ms per {B_SLICE} Rayleigh + "
        f"Love curve pairs, {B_SLICE / best:.1f} pairs/s; the independent "
        f"Rayleigh + Love solves {indep:.2f} ms ({B_SLICE * 1e3 / indep:.1f}"
        f" pairs/s) ({card})")

    kern = {}
    for wave, cfg in waves.items():
        model = lane_model(arrs, nl, wave)
        c_init = _initial_c(arrs[0], arrs[2], arrs[4], nl,
                            periods[0].expand(B_SLICE), wave, cfg)
        cs = (c_init[None] + cfg.coarse_first * DC
              * torch.arange(33, device=dev, dtype=torch.float32)[:, None])
        ts = periods[0].expand(cs.shape).contiguous()
        mm0 = torch.zeros(cs.shape, dtype=torch.int32, device=dev)
        out = out_r if wave == "rayleigh" else out_l
        root = torch.where(out[2], out[0], 3.5)[:, :, 0].T.contiguous()
        tk = periods[:, None].expand(root.shape).contiguous()
        _, _, mm = sl.secular_lanes(root + DC, tk, mm0[:18], *model, nl,
                                    wave=wave)
        lo, hi, mmb = sweep_brackets(sl, root, tk, model, nl, wave)
        n_ill = cfg.nbisect
        calls = {
            "secular_lanes": lambda b: sl.secular_lanes(
                cs, ts, mm0, *model, nl, wave=wave, backend=b),
            "secular_lanes_frozen": lambda b: sl.secular_lanes_frozen(
                root, tk, mm, *model, nl, wave=wave, backend=b),
            "secular_lanes_grad": lambda b: sl.secular_lanes_grad(
                root, tk, mm, *model, nl, wave=wave, backend=b),
            "refine_lanes": lambda b: sl.refine_lanes(
                lo, hi, tk, mmb, *model, nl, wave=wave, n_ill=n_ill,
                n_newton=2, backend=b),
        }
        _, _, mm_cs = sl.secular_lanes(cs, ts, mm0, *model, nl, wave=wave)
        per_lane = OPS_PER_LAYER[wave]
        applied = {"secular_lanes": layers_applied(mm_cs, L),
                   "secular_lanes_frozen": layers_applied(mm, L),
                   "secular_lanes_grad": layers_applied(mm, L),
                   "refine_lanes": layers_applied(mmb, L)}
        model_bytes = 7 * L * B_SLICE * 4
        for name, fn in calls.items():
            ms = time_cuda(lambda: fn("kernel"), n=5)
            # one call of the plain version (0.2-11 s of host-bound
            # PyTorch ops; a warm-up and more windows would add minutes)
            pms = time_cuda(lambda: fn("plain"), n=1, windows=1, warm=0)
            K = 33 if name == "secular_lanes" else 18
            lanes_io = {"secular_lanes": 7, "secular_lanes_frozen": 4,
                        "secular_lanes_grad": 6, "refine_lanes": 6}[name]
            nbytes = model_bytes + lanes_io * K * B_SLICE * 4 + (
                B_SLICE * 4 if name == "secular_lanes" else 0)
            evals = {"secular_lanes": 1, "secular_lanes_frozen": 1,
                     "secular_lanes_grad": DUAL_FACTOR,
                     "refine_lanes": n_ill + 2 + 2 * DUAL_FACTOR}[name]
            ops = per_lane + (WALK_OPS_PER_LAYER[wave]
                              if name == "secular_lanes" else 0)
            bms, bby = bound(nbytes, applied[name] * ops * evals)
            kern[(name, wave)] = (ms, pms, bms, bby)
            log(f"[time] {name} {wave} K={K} B={B_SLICE} L={L}: kernel "
                f"{ms:.3f} ms, plain {pms:.3f} ms, bound {bms:.3f} ms "
                f"({bby}) ({card})")
        # refine_lanes against the separate launches it replaces: the
        # Illinois frozen launches + the Newton/tangent gradient launches
        # of the same evaluation count, with the tensor ops between them

        def separate():
            r = _illinois(lambda x: sl.secular_lanes_frozen(
                x, tk, mmb, *model, nl, wave=wave), lo, hi, n_ill)
            for _ in range(2):
                f, fc, _ = sl.secular_lanes_grad(r, tk, mmb, *model, nl,
                                                 wave=wave)
                r = torch.minimum(torch.maximum(r - f / fc, lo), hi)
            return r

        sep_ms = time_cuda(separate, n=3)
        kern[("separate_2_3", wave)] = sep_ms
        log(f"[time] refine_lanes {wave} n_newton 2 (one call, two kernels) "
            f"{kern[('refine_lanes', wave)][0]:.3f} ms vs the separate "
            f"launches it replaces ({n_ill + 2} secular_lanes_frozen + 2 "
            f"secular_lanes_grad + glue) {sep_ms:.3f} ms ({card})")
        # the fuse_illinois form (n_newton 0: the Illinois kernel alone)
        # against the Illinois frozen launches and glue it replaces
        def ill(b):
            return sl.refine_lanes(lo, hi, tk, mmb, *model, nl, wave=wave,
                                   n_ill=n_ill, n_newton=0,
                                   compute_group=False, backend=b)

        ill_ms = time_cuda(lambda: ill("kernel"), n=5)
        ill_pms = time_cuda(lambda: ill("plain"), n=1, windows=1, warm=0)
        # n_ill + 2 float evaluations; the same inputs and outputs
        ill_bms, ill_bby = bound(model_bytes + 6 * 18 * B_SLICE * 4,
                                 applied["refine_lanes"] * per_lane
                                 * (n_ill + 2))
        sep_ill_ms = time_cuda(lambda: _illinois(
            lambda x: sl.secular_lanes_frozen(x, tk, mmb, *model, nl,
                                              wave=wave), lo, hi, n_ill), n=3)
        kern[("nnewton0", wave)] = (ill_ms, sep_ill_ms, ill_pms, ill_bms,
                                    ill_bby)
        log(f"[time] refine_lanes {wave} n_newton 0 (the Illinois kernel) "
            f"{ill_ms:.3f} ms, plain {ill_pms:.3f} ms, bound {ill_bms:.3f} "
            f"ms ({ill_bby}), vs the separate launches it replaces "
            f"({n_ill + 2} secular_lanes_frozen + glue) {sep_ill_ms:.3f} ms "
            f"({card})")
        sampler_size_times(sl, kern, [a[:B_SAMPLER] for a in arrs],
                           nl[:B_SAMPLER], root[:, :B_SAMPLER].contiguous(),
                           tk[:, :B_SAMPLER].contiguous(), wave, n_ill,
                           lane_model, card)

    mark("time")
    kernels = []
    for name, rep in REPLACES.items():
        ms, pms, bms, bby = kern[(name, "rayleigh")]
        lms, lpms, lbms, _ = kern[(name, "love")]
        extra = {k: v for k, v in kerr[name].items() if k != "max_abs_err"}
        if name == "refine_lanes":
            extra.update(separate_launches_ms=kern[("separate_2_3",
                                                    "rayleigh")],
                         love_separate_launches_ms=kern[("separate_2_3",
                                                         "love")],
                         nnewton0_ms={w: kern[("nnewton0", w)][0]
                                      for w in waves},
                         nnewton0_plain_ms={w: kern[("nnewton0", w)][2]
                                            for w in waves},
                         nnewton0_bound_ms={w: kern[("nnewton0", w)][3]
                                            for w in waves},
                         nnewton0_bound_by=kern[("nnewton0", "rayleigh")][4],
                         nnewton0_launches_solve_path=launches_nnewton0,
                         separate_illinois_ms={w: kern[("nnewton0", w)][1]
                                               for w in waves})
        if name == "secular_lanes":
            extra.update(sampler_k90_ms={
                w: kern[("secular_lanes_k90", w)] for w in waves})
        def per(f, name=name):
            """f of each wave's ptxas usage, by phase for a kernel
            launched as several."""
            if name in PHASES:
                return {ph: {w: f(usage[(f"{name}_{ph}", w)]) for w in waves}
                        for ph in PHASES[name]}
            return {w: f(usage[(name, w)]) for w in waves}

        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=rep,
            launches=(launches_solve[name] + launches_joint[name]
                      + launches_mc[name] + launches_exp[name]),
            max_abs_err=kerr[name]["max_abs_err"],
            ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
            library_ms=None,
            launches_solve_path=launches_solve[name],
            launches_sampler_path=launches_mc[name],
            launches_joint_path=launches_joint[name],
            launches_experimental_path={
                r: exp[r]["launches"][name]
                for r in ("adaptive", "tuned_rwm", "mala")},
            launches_by_sampler_run={
                r: mc[r]["launches"][name]
                for r in ("default_first_call", "default", "lane_ranges",
                          "nnewton2")},
            love_ms=lms, love_plain_ms=lpms, love_bound_ms=lbms,
            shape=f"K={33 if name == 'secular_lanes' else 18},B={B_SLICE},"
                  f"L={L}", bitwise=bits[name],
            registers=per(lambda u: u[0]), spill_bytes=per(lambda u: u[1]),
            occupancy=per(lambda u: occupancy(u[0])),
            sampler_ms={w: kern[(name + "_sampler", w)] for w in waves},
            **extra))

    for k in DL.KERNELS:
        name = k.__name__
        runs = {r: mc[r]["launches"][name]
                for r in ("default_first_call", "default", "lane_ranges",
                          "nnewton2")}
        kernels.append(dict(
            name=name, route="cuda", source=DRAW_SOURCE,
            replaces="jax.random under the JAX sampler's jit (no kernel)",
            launches=(launches_draw[name] + launches_mc[name]
                      + launches_exp[name] + mc["legacy"]["launches"][name]),
            launches_draw_phase=launches_draw[name],
            launches_sampler_path=launches_mc[name],
            launches_by_sampler_run=runs,
            launches_legacy=mc["legacy"]["launches"][name],
            launches_experimental_path={
                r: exp[r]["launches"][name]
                for r in ("adaptive", "tuned_rwm", "mala")},
            bitwise=all(c["bitwise"] for c in draws["calls"].values()
                        if c["launches"][name]),
            calls={w: c for w, c in draws["calls"].items()
                   if c["launches"][name]}))

    log(f"[time] summary ({card}): solves/s " + json.dumps(
        {k: round(v, 1) for k, v in solves.items()}) + "; single-model "
        + json.dumps(single) + "; analysis " + json.dumps(analysis)
        + "; draws " + json.dumps(draws) + "; prior " + json.dumps(prior)
        + "; sampler " + json.dumps(mc) + "; experimental "
        + json.dumps(exp)
        + f"; chip_smoke {time.perf_counter() - t_start:.1f} s"
        " (by phase: " + ", ".join(f"{k} {v:.1f} s" for k, v in phase_s.items())
        + ")")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def layers_applied(mm, L):
    """Applied layer steps of a launch's lanes: each lane propagates
    through the mm - 1 layers above its closure."""
    return float((mm.long() - 1).clamp(0, L - 1).sum())


def sweep_brackets(sl, root, tk, model, nlay, wave):
    """dc-wide brackets from a secular_lanes sweep: 0.01 km/s rungs from
    0.1 km/s below each lane's root, the first sign change, the closure
    frozen at the upper end (the solver's convention)."""
    import torch
    n = 21
    rung = 0.01 * torch.arange(n, device=root.device, dtype=root.dtype)
    cs = (root[None] - 0.1 + rung[:, None, None]).reshape(-1, root.shape[1])
    F, _, mm = sl.secular_lanes(cs.contiguous(), tk.repeat(n, 1),
                                torch.zeros(cs.shape, dtype=torch.int32,
                                            device=root.device),
                                *model, nlay, wave=wave)
    s = torch.sign(F).reshape(n, *root.shape)
    i = torch.argmax((s[:-1] != s[1:]).to(torch.int8), dim=0)
    csr = cs.reshape(n, *root.shape)
    lo = csr.gather(0, i[None])[0].contiguous()
    mm = mm.reshape(n, *root.shape).gather(0, (i + 1)[None])[0].contiguous()
    return lo, (lo + 0.01).contiguous(), mm


# the survey sampler's retry pyramid at its 1,920 lanes (propose_flat 2048,
# propose_ratio 2, min_stage 32): each stage's lanes M and draws a lane a
# round W = 2048 // M
DRAW_STAGES = ((1920, 1), (960, 2), (480, 4), (240, 8), (120, 17), (60, 34))
DRAW_SOURCE = "pysurfinv_tpu_torch/csrc/draw_lanes.cu"


def draw_phase(dev, card):
    """Phase 3b: the draw kernels against their plain torch ops on the
    card at the survey's shapes (module docstring).  Returns (launches
    summed over the phase, numbers)."""
    import torch

    from pysurfinv_tpu_torch.inversion import mcmc
    from pysurfinv_tpu_torch.inversion import random as R
    from pysurfinv_tpu_torch.inversion.compiled import (BrownianSpec,
                                                        CompiledModel)
    from pysurfinv_tpu_torch.ops import draw_lanes as DL

    t0 = time.perf_counter()
    _, info = DL.draw_library()
    log(f"[draws] draw kernels: nvcc {info['seconds']:.1f} s, load total "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    pts, _ = mc_points(1)
    ref = CompiledModel(pts[0].initMod).spec_of(pts[0].initMod)
    P = ref.theta0.shape[0]
    B = B_SAMPLER
    g = torch.Generator().manual_seed(MC_SEED)
    lanes = {f: torch.as_tensor(getattr(ref, f)).expand(B, P)
             for f in BrownianSpec._fields}
    theta = lanes["vmin"] + (lanes["vmax"] - lanes["vmin"]) * torch.rand(
        B, P, generator=g, dtype=torch.float64)
    spec = BrownianSpec(theta.to(dev), *(lanes[f].contiguous().to(dev)
                                         for f in BrownianSpec._fields[1:]))
    keys = R.fold_in(R.PRNGKey(MC_SEED), torch.arange(B)).to(dev)

    launches = {k.__name__: 0 for k in DL.KERNELS}
    calls = {}

    def compare(what, call, want):
        """``call`` on the kernels (with ``want`` launches of each) and
        on the plain ops: bit for bit, and each one's ms a call."""
        DL.reset_launch_counts()
        got = call()
        torch.cuda.synchronize()
        n = {k.__name__: k.launches for k in DL.KERNELS}
        check(n == {k: want.get(k, 0) for k in n},
              f"draws {what}: launches {n}, expected {want}")
        with draws_on("plain"):
            plain = call()
            check([k.launches for k in DL.KERNELS] == list(n.values()),
                  f"draws {what}: the plain ops launched a draw kernel")
            plain_ms = time_cuda(call, n=2, windows=2)
        same = bitwise(got, plain)
        check(same, f"draws {what}: the kernels differ from the plain ops")
        ms = time_cuda(call, n=20)
        for k, v in n.items():
            launches[k] += v
        calls[what] = dict(bitwise=same, launches=n,
                           kernel_us=round(ms * 1e3, 2),
                           plain_ms=round(plain_ms, 3))
        log(f"[draws] {what}: bitwise {same}, launches {n}, "
            f"{ms * 1e3:.2f} us (plain ops {plain_ms:.3f} ms) ({card})")

    for M, W in DRAW_STAGES:
        sub = BrownianSpec(*(x[:M] for x in spec))
        for n_pert in sorted({W, W // 2, 0}, reverse=True):
            cfg = mcmc.ChainConfig(n_perturb_rounds=n_pert)
            compare(f"draw_round M={M} W={W} n_pert={n_pert}",
                    lambda: mcmc._draw_round(0, keys[:M], sub.theta0, sub, W,
                                             cfg),
                    {"draw_round": 1})
    compare(f"fold_in step key M={B}", lambda: R.fold_in(keys, 2 * 37),
            {"fold_in": 1})
    compare(f"uniform acceptance M={B}",
            lambda: R.uniform(R.fold_in(keys, 2 * 37 + 1), (),
                              dtype=torch.float64),
            {"fold_in": 1, "random_bits": 1})
    n_ch = MC_RUN_N // MC_CHAIN_L
    compare(f"split legacy step keys {n_ch} x {MC_CHAIN_L - 1}",
            lambda: R.split(keys[:n_ch], MC_CHAIN_L - 1), {"fold_in": 1})
    compare(f"normal adaptive 6 x {P}",
            lambda: R.normal(keys[:6], (P,), torch.float64),
            {"random_bits": 1})
    DL.reset_launch_counts()
    return launches, dict(P=P, calls=calls)


# the survey prior's batch shapes: the retry pyramid's stages 1,920 x 1 to
# 240 x 8, and 120 x 17 and 60 x 34
PRIOR_SHAPES = (1920, 2040)


def prior_phase(card):
    """Phase 3c: the prior's CUDA graphs against its plain ops on the card
    at the survey's shapes (module docstring).  Returns its numbers."""
    import torch

    from pysurfinv_tpu_torch import profiling
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel

    pts, _ = mc_points(MC_POINTS)
    mods = [p.initMod for p in pts]
    g = torch.Generator().manual_seed(MC_SEED)
    out = {}
    for dtype in (torch.float64, torch.float32):
        cm = CompiledModel(mods[0])
        specs = [cm.spec_of(m) for m in mods]
        psis = np.stack([cm.psi_of(m) for m in mods])
        for n in PRIOR_SHAPES:
            idx = np.arange(n) % len(pts)
            lo, hi = (torch.as_tensor(np.stack([getattr(specs[i], f)
                                                for i in idx]))
                      for f in ("vmin", "vmax"))
            psi = torch.as_tensor(psis[idx]).to("cuda", dtype)

            def batch():
                u = torch.rand(lo.shape, generator=g, dtype=torch.float64)
                return (lo - 0.25 * (hi - lo) + 1.5 * (hi - lo) * u).to(
                    "cuda", dtype)

            ths = [batch(), batch()]
            profiling.reset_counters()
            with profiling.counting():
                got = [cm.isgood(th, psi) for th in ths + ths[:1]]
            counted = profiling.counters()
            profiling.reset_counters()
            plain = [cm._isgood_plain(th, psi) for th in ths]
            same = all(torch.equal(a, b) for a, b in
                       zip(got, plain + plain[:1]))
            what = f"{str(dtype)[6:]} N={n}"
            check(same, f"prior {what}: the graph differs from the plain ops")
            check(not torch.equal(plain[0], plain[1]),
                  f"prior {what}: the two batches give one mask")
            check(counted.get("prior.graph_captures") == 1
                  and counted.get("prior.graph_replays") == 3
                  and "prior.plain_calls" not in counted,
                  f"prior {what}: counters {counted}")
            ms = time_cuda(lambda: cm.isgood(ths[0], psi), n=20)
            plain_ms = time_cuda(lambda: cm._isgood_plain(ths[0], psi), n=5)
            out[what] = dict(bitwise=same, accepted=int(plain[0].sum()),
                             graph_ms=round(ms, 4),
                             plain_ms=round(plain_ms, 4))
            log(f"[prior] {what}: bitwise {same}, "
                f"{int(plain[0].sum())} of {n} lanes accepted, graph "
                f"{ms:.3f} ms (plain ops {plain_ms:.3f} ms) ({card})")
    return out


def mc_points(n):
    """bench.py:249-260: the reference's example point at n grid points,
    sedthk and lithoAge drawn from default_rng(0)."""
    from pysurfinv_tpu_torch.inversion.point import PointCascadia
    rng = np.random.default_rng(0)
    pts, lls = [], []
    for k in range(n):
        local = dict(MC_LOCAL)
        local["sedthk"] = float(0.02 + 0.9 * rng.random())
        local["lithoAge"] = float(0.5 + 8.0 * rng.random())
        pts.append(PointCascadia(MC_SETTING, local, periods=PERIODS,
                                 vels=MC_VELS, uncers=MC_UNCERS))
        lls.append((228.0 + 0.1 * (k % 8), 45.0 + 0.1 * (k // 8)))
    return pts, lls


def read_tracks(paths):
    return np.stack([np.load(p, allow_pickle=True)["mcTrack"]
                     for p in paths])


def sampler_phase(sl, card):
    """Phase 5: the batched MCMC sampler on the card.  Returns the
    sampler path's launch counts (every run summed), its numbers and the
    directory of the timed run's files."""
    import torch
    from unittest import mock

    from pysurfinv_tpu_torch.ops import draw_lanes as DL
    from pysurfinv_tpu_torch.parallel import grid

    out = tempfile.mkdtemp(prefix="chip_smoke_mc_")
    pts, lls = mc_points(MC_POINTS)
    lanes = MC_POINTS * (MC_RUN_N // MC_CHAIN_L)

    # kernels against plain versions, through the whole sampler: 2 points
    # x 4 chains x 6 steps in 2 segments (a warm step of the plain
    # versions takes ~10 s on the card); the solve's backend and the draws'
    cfg0 = grid.mcmc_solver_cfg
    sub = {}
    for backend in ("auto", "plain"):  # auto: the kernels, on the card
        DL.reset_launch_counts()
        with mock.patch.object(grid, "mcmc_solver_cfg",
                               lambda b=backend: replace(cfg0(), backend=b)),\
                draws_on(backend):
            paths = grid.invert_grid(pts[:2], lls[:2],
                                     outdir=f"{out}/sub_{backend}", runN=24,
                                     chainL=6, seed=MC_SEED, segment=3,
                                     verbose=False)
        drawn = [k.launches for k in DL.KERNELS]
        check(all(drawn) if backend == "auto" else not any(drawn),
              f"sampler {backend}: draw kernel launches {drawn}")
        sub[backend] = read_tracks(paths)
    a, b = sub["auto"], sub["plain"]
    same_theta = bool(np.array_equal(a[..., 2:], b[..., 2:]))
    dmis = float(np.abs(a[..., 0] - b[..., 0]).max())
    check(same_theta and dmis <= 1e-6 * float(np.abs(b[..., 0]).max()),
          f"sampler tracks with the kernels differ from the plain "
          f"versions' (thetas/accepts equal {same_theta}, max|dmisfit| "
          f"{dmis:.3e})")
    log(f"[sampler] 2 points x 4 chains x 6 steps: kernels vs plain "
        f"versions: thetas and accepts equal {same_theta}, max|dmisfit| "
        f"{dmis:.3e}, bitwise {bool(np.array_equal(a, b))} ({card})")

    kernels = sl.KERNELS + DL.KERNELS
    launches = {k.__name__: 0 for k in kernels}
    res, tracks = {}, {}
    flagship = dict(runN=MC_RUN_N, chainL=MC_CHAIN_L, seed=MC_SEED,
                    segment=MC_SEGMENT, verbose=False)
    need_default = ("secular_lanes", "secular_lanes_frozen",
                    "secular_lanes_grad", "draw_round", "fold_in",
                    "random_bits")

    def drive(name, call, need, env=None):
        """Run ``call`` (-> (paths, launch counts)) with every count set
        to 0 just before; check the counts, the files and the tracks."""
        sl.reset_launch_counts()
        DL.reset_launch_counts()
        with mock.patch.dict(os.environ, env or {}):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths, got = call()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        for k, n in got.items():
            launches[k] += n
        for k in need:
            check(got[k] > 0, f"sampler run {name}: {k} was not launched")
        check(len(paths) == MC_POINTS and all(os.path.exists(p)
                                              for p in paths),
              f"sampler run {name}: npz files missing")
        tr = read_tracks(paths)
        check(tr.shape == (MC_POINTS, MC_RUN_N, 9),
              f"sampler run {name}: track shape {tr.shape}")
        check(bool(np.isfinite(tr).all()),
              f"sampler run {name}: non-finite values in the tracks")
        fails = int((tr[..., 0] >= 88888).sum())
        acc = float(tr[..., 2].mean())
        rate = MC_POINTS * MC_RUN_N / sec
        res[name] = dict(seconds=round(sec, 2), solves_per_sec=round(rate, 1),
                         acceptance=round(acc, 4), failed_rows=fails,
                         launches=got)
        tracks[name] = (paths, tr)
        log(f"[sampler] {name}: {MC_POINTS} points x {MC_RUN_N // MC_CHAIN_L}"
            f" chains x {MC_CHAIN_L} steps ({lanes} lanes): {sec:.2f} s, "
            f"{rate:.1f} effective solves/s, acceptance {acc:.4f}, "
            f"{fails} rows with a failed solve, min misfit "
            f"{float(tr[..., 0].min()):.4f}, launches {got} ({card})")

    def counts():
        return {k.__name__: k.launches for k in kernels}

    # the first call: checkpointed, killed after its first segment (the
    # test hook raises KeyboardInterrupt), then resumed from the file
    ck = f"{out}/resume.ck.npz"
    halves = {}

    def first_call():
        t0 = time.perf_counter()
        try:
            grid.invert_grid(pts, lls, outdir=f"{out}/resume", checkpoint=ck,
                             _abort_after_segments=1, **flagship)
        except KeyboardInterrupt:
            pass
        else:
            check(False, "the checkpointed run did not stop after its "
                  "first segment")
        halves["first"] = time.perf_counter() - t0
        halves["checkpoint_bytes"] = os.path.getsize(ck)
        t0 = time.perf_counter()
        paths = grid.invert_grid(pts, lls, outdir=f"{out}/resume",
                                 checkpoint=ck, resume=True, **flagship)
        halves["resumed"] = time.perf_counter() - t0
        return paths, counts()

    drive("default_first_call", first_call, need_default)
    res["default_first_call"].update(
        first_half_s=round(halves["first"], 2),
        resumed_half_s=round(halves["resumed"], 2),
        checkpoint_bytes=halves["checkpoint_bytes"])
    log(f"[sampler] checkpoint/resume (first call): {halves['first']:.2f} s "
        f"to the kill after segment 1 of {MC_CHAIN_L // MC_SEGMENT}, "
        f"checkpoint {halves['checkpoint_bytes']} bytes, resumed half "
        f"{halves['resumed']:.2f} s ({card})")

    write_s = {}

    def timed_call():
        stats = {}
        paths = grid.invert_grid(pts, lls, outdir=f"{out}/default",
                                 stats=stats, **flagship)
        write_s["streamed"] = stats["write"]
        return paths, counts()

    drive("default", timed_call, need_default)
    same = np.array_equal(tracks["default_first_call"][1],
                          tracks["default"][1])
    check(same, "the resumed run's tracks differ from the uninterrupted "
          "run's")
    log(f"[sampler] resumed tracks bitwise equal to the timed "
        f"uninterrupted call's: {same} ({card})")

    def ranges_call():
        stats = {}
        paths = grid.invert_grid(pts, lls, outdir=f"{out}/ranges",
                                 device=["cuda:0", "cuda:0"], stats=stats,
                                 **flagship)
        rng = stats["ranges"]
        check(len(rng) == 2, f"lane ranges: {len(rng)} ranges ran, not 2")
        for r in rng:
            for k in need_default:
                check(r["launches"][k] > 0, f"lane range {r['lanes']}: {k} "
                      "was not launched in its process")
        res["ranges_detail"] = [dict(lanes=r["lanes"], device=r["device"],
                                     seconds=round(r["seconds"], 2),
                                     launches=r["launches"]) for r in rng]
        # the ranges' processes launched the kernels; this one none
        return paths, {k: sum(r["launches"][k] for r in rng)
                       for k in counts()}

    drive("lane_ranges", ranges_call, need_default)
    same = np.array_equal(tracks["lane_ranges"][1], tracks["default"][1])
    check(same, "the lane-range run's tracks differ from the one-range "
          "run's")
    log(f"[sampler] lane ranges {res['ranges_detail']}: tracks bitwise "
        f"equal to the timed one-range call's: {same} ({card})")

    drive("nnewton2",
          lambda: (grid.invert_grid(pts, lls, outdir=f"{out}/nnewton2",
                                    **flagship), counts()),
          ("secular_lanes", "refine_lanes", "draw_round"),
          env={"PYSURFINV_MCMC_NNEWTON": "2",
               "PYSURFINV_MCMC_NEWTON_SEP": "0"})
    check(res["nnewton2"]["launches"]["secular_lanes_grad"] == 0,
          "sampler run nnewton2 still took the newton_sep path")
    log(f"[sampler] mcmc_effective_solves_per_sec (second call, newton_sep"
        f" 3): {res['default']['solves_per_sec']}; first call "
        f"{res['default_first_call']['seconds']} s; nnewton2 "
        f"{res['nnewton2']['solves_per_sec']} ({card})")

    res["write"] = writer_check(grid, pts, lls, out, tracks["default"],
                                write_s["streamed"], card)
    res["posterior"] = posterior_check(tracks["default"][0],
                                       tracks["nnewton2"][0], card)

    # one short run under the profiler: device busy share of the steps
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grid.invert_grid(pts, lls, outdir=f"{out}/prof",
                         runN=6 * (MC_RUN_N // MC_CHAIN_L), chainL=6,
                         seed=MC_SEED, segment=6, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa
    ours = [e for e in ev if "secular" in e.key or "refine" in e.key]
    busy = sum(dev_us(e) for e in ev) / 1e6
    k_ms = sum(dev_us(e) for e in ours) / 1e3
    n_other = sum(e.count for e in ev if e not in ours and dev_us(e) > 0)
    log(f"[sampler] profile of a 6-row run ({lanes} lanes: the init row's "
        f"cold solve + 5 steps): wall {wall:.3f} s, device busy "
        f"{busy:.3f} s, idle share {1 - busy / wall:.3f}; the secular "
        f"kernels {k_ms:.1f} ms in {sum(e.count for e in ours)} launches, "
        f"other PyTorch kernels {busy * 1e3 - k_ms:.1f} ms in {n_other} "
        f"launches ({card})")
    res["profile"] = dict(wall_s=round(wall, 3), device_busy_s=round(busy, 3),
                          idle_share=round(1 - busy / wall, 3),
                          secular_kernels_ms=round(k_ms, 2),
                          other_kernel_launches=n_other)

    # where the host time of those steps goes: cProfile by function
    import cProfile
    import pstats
    pr = cProfile.Profile()
    pr.enable()
    t0 = time.perf_counter()
    grid.invert_grid(pts, lls, outdir=f"{out}/cprof",
                     runN=6 * (MC_RUN_N // MC_CHAIN_L), chainL=6,
                     seed=MC_SEED, segment=6, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pr.disable()
    st = pstats.Stats(pr).stats
    by_fn = {}
    for (fname, _, fn), (_, _, tt, ct, _) in st.items():
        mod = os.path.basename(fname)
        if "pysurfinv_tpu_torch" in fname:
            key = f"{mod}:{fn}"
            by_fn[key] = max(by_fn.get(key, 0.0), ct)
    top = sorted(by_fn.items(), key=lambda kv: -kv[1])[:14]
    log(f"[sampler] host profile of the same 6-row run (cProfile, "
        f"{wall:.3f} s): cumulative s by function: " + "; ".join(
            f"{k} {v:.3f}" for k, v in top) + f" ({card})")
    return launches, res, f"{out}/default"


def writer_check(grid, pts, lls, out, default, streamed_s, card):
    """The streamed npz writer: the timed run's 64 files (rows deflated
    lane by lane during the segments, assembled without recompression)
    rewritten by the ``PYSURFINV_STREAM_NPZ=0`` path (``savez_fast``);
    every array must load equal.  Returns the write seconds."""
    paths, tr = default
    lanes = tr.reshape(MC_POINTS * (MC_RUN_N // MC_CHAIN_L), MC_CHAIN_L, -1)
    t0 = time.perf_counter()
    plain = grid.write_chain_files(pts, lls, f"{out}/savez", lanes,
                                   MC_CHAIN_L)
    savez_s = time.perf_counter() - t0
    sizes = [sum(os.path.getsize(p) for p in ps) for ps in (paths, plain)]
    for a, b in zip(paths, plain):
        da, db = (np.load(x, allow_pickle=True) for x in (a, b))
        check(sorted(da.files) == sorted(db.files),
              f"streamed {a}: entries {da.files} vs {db.files}")
        check(np.array_equal(da["mcTrack"], db["mcTrack"])
              and da["mcTrack"].dtype == db["mcTrack"].dtype,
              f"streamed {a}: mcTrack differs from the savez_fast file's")
        for k in ("setting", "obs", "invMeta"):
            check(repr(da[k][()]) == repr(db[k][()]),
                  f"streamed {a}: {k} differs from the savez_fast file's")
    log(f"[sampler] npz write of the timed run's {len(paths)} files: "
        f"streamed {streamed_s:.3f} s (assembly; the deflation ran during "
        f"the segments), savez_fast {savez_s:.3f} s; every array loads "
        f"equal; {sizes[0]} vs {sizes[1]} bytes ({card})")
    return dict(streamed_s=round(streamed_s, 3),
                savez_fast_s=round(savez_s, 3), streamed_bytes=sizes[0], savez_fast_bytes=sizes[1])


def posterior_check(files_a, files_b, card):
    """The posterior comparator on two solver settings of one posterior
    (the timed run, newton_sep 3, and the nnewton2 run): every chain
    statistic's z-score finite; the verdict printed, not gated (a 1% test
    refuses 1% of honest runs)."""
    from pysurfinv_tpu_torch.inversion.parity import (chain_statistics,
                                                      compare_posteriors,
                                                      pooled_threshold)
    t0 = time.perf_counter()
    thres = pooled_threshold([files_a, files_b])
    sa, _ = chain_statistics(files_a, thres=thres)
    sb, _ = chain_statistics(files_b, thres=thres)
    verdict = compare_posteriors(sa, sb, n_perm=2000)
    sec = time.perf_counter() - t0
    zs = np.array(list(verdict["z"].values()))
    check(len(zs) == len(sa) and bool(np.isfinite(zs).all()),
          f"posterior comparator: non-finite z-scores {verdict['z']}")
    check(all(0 <= verdict[k] <= 1 for k in ("p_max", "p_rms", "p_mean",
                                             "p_value")),
          "posterior comparator: p-values outside [0, 1]")
    conv = (float(np.mean(sa["converged"])), float(np.mean(sb["converged"])))
    out = dict(p_value=verdict["p_value"], max_abs_z=verdict["max_abs_z"],
               worst=verdict["worst"], n_a=verdict["n_a"],
               n_b=verdict["n_b"], threshold=thres,
               converged_share=conv, seconds=round(sec, 2))
    log(f"[posterior] default vs nnewton2 (chain statistics of "
        f"{verdict['n_a']} + {verdict['n_b']} chains, pooled threshold "
        f"{thres:.4f}, converged share {conv[0]:.3f} / {conv[1]:.3f}): "
        + json.dumps(out) + f" ({card})")
    return out


def legacy_check(dev, card):
    """The per-chain legacy sampler through Point.MCinvMP: 1 point x 2
    chains x 4 steps on 5 periods on the card, against the same call on
    CPU tensors (accepts equal, thetas to 1e-10, misfits to 1e-9
    relative)."""
    from pysurfinv_tpu_torch.inversion.point import PointCascadia
    from pysurfinv_tpu_torch.ops import draw_lanes as DL
    out = tempfile.mkdtemp(prefix="chip_smoke_legacy_")
    sub = slice(0, 18, 4)
    tr, secs = {}, {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        p = PointCascadia(MC_SETTING, dict(MC_LOCAL), periods=PERIODS[sub],
                          vels=MC_VELS[sub], uncers=MC_UNCERS[sub])
        DL.reset_launch_counts()
        t0 = time.perf_counter()
        p.MCinvMP(f"{out}/{name}", pid="p", runN=8, chainL=4, seed=MC_SEED,
                  sampler="legacy", verbose=False, device=device)
        secs[name] = time.perf_counter() - t0
        if name == "card":   # the card's draws on the draw kernels
            drawn = {k.__name__: k.launches for k in DL.KERNELS}
        tr[name] = np.load(f"{out}/{name}/p.npz",
                           allow_pickle=True)["mcTrack"]
    check(all(drawn.values()),
          f"legacy sampler on the card: draw kernel launches {drawn}")
    a, b = tr["card"], tr["cpu"]
    check(a.shape == b.shape == (8, 9) and bool(np.isfinite(a).all()),
          f"legacy sampler: tracks {a.shape} / {b.shape}")
    # the proposals' erfinv / exp round differently in the card's libm and
    # the CPU's: thetas to 1e-10 (the CPU tests' tolerance against JAX)
    dth = float(np.abs(a[:, 3:] - b[:, 3:]).max())
    same_acc = bool(np.array_equal(a[:, 2], b[:, 2]))
    rel = float(np.max(np.abs(a[:, 0] - b[:, 0]) / np.abs(b[:, 0])))
    check(same_acc and dth <= 1e-10 and rel <= 1e-9,
          f"legacy sampler on the card vs the CPU: accepts equal "
          f"{same_acc}, max|dtheta| {dth:.3e}, misfit rel err {rel:.3e}")
    log(f"[legacy] Point.MCinvMP(sampler='legacy') 1 point x 2 chains x 4 "
        f"steps, 5 periods (8 single-model float64 solves): card "
        f"{secs['card']:.3f} s, CPU {secs['cpu']:.3f} s; accepts equal, "
        f"max|dtheta| {dth:.3e} (bitwise {bool(np.array_equal(a, b))}), "
        f"max misfit rel err {rel:.3e}, acceptance "
        f"{float(a[:, 2].mean()):.3f}; the card's draw launches {drawn} "
        f"({card})")
    return dict(card_s=round(secs["card"], 3), cpu_s=round(secs["cpu"], 3),
                theta_abs_err=dth, misfit_rel_err=rel, launches=drawn)


# phase 5c: the experimental samplers at the default lane counts of their
# entry points on the example point, depth cut (PERF.md section 4)
EXP_AM = dict(runN=1200, chainL=200)          # 6 lanes (6000 / 1000)
EXP_AM_WARMUP = dict(warmup1=64, warmup2=128, warmup3=64)
EXP_TRWM = dict(runN=1200, chainL=200, std_steps=128, rm_steps=32)
EXP_MALA = dict(runN=1500, chainL=50, tau=0.8)  # 30 lanes (6000 / 200)


def experimental_phase(sl, arrs, nl, periods, dev, card):
    """Phase 5c: ``adaptive_point``, ``tuned_rwm_point`` and ``mala_point``
    on the card.  First, at 2 lanes x 6 rows with one separated-Newton
    iteration a solve, each sampler's tracks with the kernels equal its
    tracks with the plain versions bit for bit.  Then each at its default
    lane count (6 AM lanes, 48 warm + 6 tuned lanes, 30 MALA lanes),
    every launch count set to 0 just before and read just after: row 0
    of every chain accepted, every value finite, acceptance in (0, 1]
    (above 0.05 for MALA), the AM Cholesky factor valid, PostPoint reads
    the file; seconds, steps a second, launches, and MALA's solve and
    gradient shares of a step (synchronised host clock).  Then the MALA
    gradient on the card against the CPU (4 lanes, float64) and the
    single-model solve on the tree-product secular functions
    (``SurfConfig(backend="xla_assoc")``) against the sequential one on
    bench model 0, R and L.  Returns (launch counts summed over the three
    runs, numbers)."""
    import torch
    from unittest import mock

    from pysurfinv_tpu_torch.inversion import adaptive, mala
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
    from pysurfinv_tpu_torch.inversion.point import PointCascadia, PostPoint
    from pysurfinv_tpu_torch.ops import draw_lanes as DL
    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward
    from pysurfinv_tpu_torch.parallel import grid

    out = tempfile.mkdtemp(prefix="chip_smoke_exp_")
    entry = {"adaptive": adaptive.adaptive_point,
             "tuned_rwm": adaptive.tuned_rwm_point,
             "mala": mala.mala_point}

    def point():
        return PointCascadia(MC_SETTING, dict(MC_LOCAL), periods=PERIODS,
                             vels=MC_VELS, uncers=MC_UNCERS)

    def run(name, outdir, **kw):
        """One sampler's entry point on the example point, on the card:
        its track."""
        path = entry[name](point(), outdir=outdir, pid=name, seed=MC_SEED,
                           device=dev, **kw)
        return path, np.load(path, allow_pickle=True)["mcTrack"]

    def sync_time(fn):
        """fn() and its seconds between two synchronisations."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # ---- kernels against plain versions through each sampler -----------
    # one separated-Newton iteration a solve, not 3: a plain gradient
    # launch takes ~3 s on the card; the same four kernels launch
    small = {"adaptive": dict(runN=12, chainL=6, acfg=adaptive.AdaptConfig(
                 warmup1=1, warmup2=1, warmup3=1)),
             "tuned_rwm": dict(runN=12, chainL=6, std_steps=2, rm_steps=2,
                               warm_lanes=6),
             "mala": dict(runN=12, chainL=6, tau=0.8)}
    for name in entry:
        tr, secs = {}, {}
        for backend in ("auto", "plain"):   # auto: the kernels, on the card
            scfg = replace(grid.mcmc_solver_cfg(), backend=backend,
                           newton_sep=1)
            DL.reset_launch_counts()
            with draws_on(backend):
                (_, tr[backend]), secs[backend] = sync_time(lambda: run(
                    name, f"{out}/sub_{backend}", scfg=scfg, **small[name]))
            drawn = [k.launches for k in DL.KERNELS]
            check(any(drawn) if backend == "auto" else not any(drawn),
                  f"{name} {backend}: draw kernel launches {drawn}")
        same = bool(np.array_equal(tr["auto"], tr["plain"]))
        check(same and tr["auto"].shape == (12, 9),
              f"{name}: tracks with the kernels differ from the plain "
              f"versions' (max|d| "
              f"{float(np.abs(tr['auto'] - tr['plain']).max()):.3e})")
        log(f"[exp] {name} 2 lanes x 6 rows: kernels vs plain versions "
            f"bitwise {same}; {secs['auto']:.2f} s vs "
            f"{secs['plain']:.2f} s ({card})")

    # ---- the main runs: default lane counts, depth cut -------------------
    kernels = sl.KERNELS + DL.KERNELS
    launches = {k.__name__: 0 for k in kernels}
    need = ("secular_lanes", "secular_lanes_frozen", "secular_lanes_grad",
            "fold_in", "random_bits")
    frozen = {}
    make_am = adaptive.make_adaptive_sampler

    def am_spy(*a, **kw):
        """make_adaptive_sampler whose warmup_fn keeps its frozen
        proposal for the checks below."""
        init_fn, warmup_fn, run_fn = make_am(*a, **kw)

        def warm(*wa):
            carry, chol, scale = warmup_fn(*wa)
            frozen["chol"], frozen["scale"] = chol, scale
            return carry, chol, scale
        return init_fn, warm, run_fn

    shares = {"solve": 0.0, "grad": 0.0}

    def timed_factory(factory, key):
        """A likelihood factory whose functions add their synchronised
        seconds to shares[key]."""
        def make(*a, **kw):
            fn = factory(*a, **kw)

            def timed(*b):
                r, sec = sync_time(lambda: fn(*b))
                shares[key] += sec
                return r
            return timed
        return make

    am_kw = dict(EXP_AM, acfg=adaptive.AdaptConfig(**EXP_AM_WARMUP))
    main = {  # (entry point arguments, lanes, sequential steps)
        "adaptive": (am_kw, EXP_AM["runN"] // EXP_AM["chainL"],
                     sum(EXP_AM_WARMUP.values()) + EXP_AM["chainL"]),
        "tuned_rwm": (EXP_TRWM, EXP_TRWM["runN"] // EXP_TRWM["chainL"],
                      EXP_TRWM["std_steps"] + 2 * EXP_TRWM["rm_steps"]
                      + EXP_TRWM["chainL"]),
        "mala": (EXP_MALA, EXP_MALA["runN"] // EXP_MALA["chainL"],
                 EXP_MALA["chainL"]),
    }
    patches = {
        "adaptive": [mock.patch.object(adaptive, "make_adaptive_sampler",
                                       am_spy)],
        "tuned_rwm": [],
        "mala": [mock.patch.object(grid, "chi_sqr_fn",
                                   timed_factory(grid.chi_sqr_fn, "solve")),
                 mock.patch.object(mala, "_grad_chi_lane",
                                   timed_factory(mala._grad_chi_lane,
                                                 "grad"))]}
    res = {}
    for name, (kw, n_chains, n_steps) in main.items():
        for p in patches[name]:
            p.start()
        try:
            sl.reset_launch_counts()
            DL.reset_launch_counts()
            (path, tr), sec = sync_time(lambda: run(name, f"{out}/main",
                                                    **kw))
            got = {k.__name__: k.launches for k in kernels}
        finally:
            for p in patches[name]:
                p.stop()
        for k, n in got.items():
            launches[k] += n
        for k in need:
            check(got[k] > 0, f"{name}: {k} was not launched")
        chain_l = kw["chainL"]
        check(tr.shape == (n_chains * chain_l, 9),
              f"{name}: track shape {tr.shape}")
        check(bool(np.isfinite(tr).all()), f"{name}: non-finite values")
        check(bool((tr[::chain_l, 2] == 1).all()),
              f"{name}: a chain's row 0 is not accepted")
        acc = float(tr[:, 2].mean())
        check(0 < acc <= 1 and (name != "mala" or acc > 0.05),
              f"{name}: acceptance {acc:.4f}")
        pp = PostPoint(path, device=dev)
        check(bool(np.isfinite(pp.misfits).all()) and pp.N == len(tr),
              f"{name}: PostPoint read {pp.N} rows")
        r = dict(lanes=n_chains, chainL=chain_l, sequential_steps=n_steps,
                 seconds=round(sec, 2),
                 steps_per_sec=round(n_steps / sec, 2),
                 samples_per_sec=round(len(tr) / sec, 1),
                 acceptance=round(acc, 4), launches=got,
                 min_misfit=round(float(tr[:, 0].min()), 4))
        extra = ""
        if name == "adaptive":
            chol = frozen["chol"].cpu().numpy()
            scale = float(frozen["scale"])
            off = float(np.abs(chol - np.diag(np.diag(chol))).sum())
            check(bool(np.isfinite(chol).all()) and scale > 0
                  and np.array_equal(chol, np.tril(chol))
                  and bool((np.diag(chol) > 0).all()),
                  f"adaptive: invalid Cholesky factor {chol} / scale "
                  f"{scale}")
            r.update(scale=round(scale, 4), chol_off_diagonal=off)
            extra = (f", scale {scale:.4f}, Cholesky off-diagonal mass "
                     f"{off:.4g}")
        if name == "mala":
            per = {k: v / n_steps for k, v in shares.items()}
            r.update(solve_share=round(shares["solve"] / sec, 3),
                     grad_share=round(shares["grad"] / sec, 3),
                     solve_s_per_step=round(per["solve"], 4),
                     grad_s_per_step=round(per["grad"], 4))
            extra = (f", a step {sec / n_steps:.3f} s: solve "
                     f"{per['solve']:.3f} s ({r['solve_share']:.3f}), "
                     f"gradient {per['grad']:.3f} s ({r['grad_share']:.3f})")
        res[name] = r
        log(f"[exp] {name}: {n_chains} chains x {chain_l} rows "
            f"({n_steps} sequential steps with the warmup): {sec:.2f} s, "
            f"{n_steps / sec:.2f} steps/s, {len(tr) / sec:.1f} samples/s, "
            f"acceptance {acc:.4f}, min misfit {float(tr[:, 0].min()):.4f}"
            f"{extra}; launches {got} ({card})")

    # ---- the MALA gradient: card against CPU, float64 ---------------------
    pt = point()
    cm = CompiledModel(pt.initMod)
    rng = np.random.default_rng(1)
    th = np.clip(cm.spec.theta0 + 0.5 * cm.spec.step
                 * rng.standard_normal((4, cm.ntheta)), cm.spec.vmin,
                 cm.spec.vmax)
    ctx = [np.repeat(np.asarray(x)[None], 4, 0)
           for x in (cm.psi0, *pt._obs_arrays())]
    scfg = grid.mcmc_solver_cfg()
    cP = grid.chi_sqr_fn(cm, PointCascadia, "rayleigh", scfg)(
        torch.as_tensor(th, device=dev),
        tuple(torch.as_tensor(x, device=dev) for x in ctx),
        torch.zeros((4, len(PERIODS)), dtype=torch.float32,
                    device=dev))[3].double().cpu()
    check(bool((cP > 0).all()), "MALA gradient check: a root failed")
    grads, gsec = {}, {}
    for where in (str(dev), "cpu"):
        g = mala._grad_chi_lane(cm, PointCascadia, scfg, "rayleigh")
        a = [torch.as_tensor(x, device=where)
             for x in (th, ctx[0], ctx[1], cP, *ctx[2:])]
        grads[where], gsec[where] = sync_time(lambda: g(*a).cpu().numpy())
    gd, gc = grads[str(dev)], grads["cpu"]
    rel = float((np.abs(gd - gc).max(axis=1)
                 / np.abs(gc).max(axis=1)).max())
    check(np.isfinite(gd).all() and rel <= 1e-9,
          f"MALA gradient card vs CPU: {rel:.3e} of each lane's max > 1e-9")
    res["grad_card_vs_cpu"] = dict(rel_err=rel,
                                   card_s=round(gsec[str(dev)], 3),
                                   cpu_s=round(gsec["cpu"], 3))
    log(f"[exp] MALA gradient (4 lanes, float64): card vs CPU {rel:.3e} of "
        f"each lane's max (held to 1e-9); card {gsec[str(dev)]:.3f} s, CPU "
        f"{gsec['cpu']:.3f} s ({card})")

    # ---- the tree-product single-model solve ------------------------------
    b0 = [a[0].to(torch.float64) for a in arrs]
    p64 = periods.to(torch.float64)
    for wave in ("rayleigh", "love"):
        sec, sol = {}, {}
        for bk in ("auto", "xla_assoc", "auto", "xla_assoc"):  # second: time
            (c, _, ok), sec[bk] = sync_time(lambda: surf_forward(
                *b0, p64, int(nl[0]), wave=wave, cfg=SurfConfig(backend=bk)))
            sol[bk] = (c, ok)
        (c0, ok0), (c1, ok1) = sol["auto"], sol["xla_assoc"]
        dc = float((c1 - c0).abs().max())
        check(bool(ok0.all()) and torch.equal(ok0, ok1) and dc <= 5e-5,
              f"xla_assoc {wave}: ok {ok1.tolist()} vs {ok0.tolist()}, "
              f"max|dc| {dc:.3e} > 5e-5")
        res[f"assoc_{wave}"] = dict(
            max_dc=dc, sequential_s_per_curve=round(sec["auto"], 3),
            assoc_s_per_curve=round(sec["xla_assoc"], 3))
        log(f"[exp] surf_forward float64 bench model 0 {wave}, "
            f"{len(p64)} periods: xla_assoc {sec['xla_assoc']:.3f} s per "
            f"curve, sequential {sec['auto']:.3f} s; max|dc| {dc:.3e} km/s "
            f"(<= 5e-5) ({card})")
    return launches, res


def model3d_phase(invdir, dev, card):
    """Model3D on the timed sampler run's 64 files, on the card: every
    point loaded (a skipped point fails the phase), Vs map, profile,
    section, smoothing (parameter space and physical grids) against the
    same calls with CPU tensors to 1e-12 of each field's max, the
    phase-velocity QC maps and the write / load round trip."""
    from pysurfinv_tpu_torch.geo.model3d import Model3D
    secs = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        secs[name] = round(time.perf_counter() - t0, 3)
        return r

    m3 = Model3D(device=dev)
    n = timed("loadInvDir", m3.loadInvDir, invdir)
    check(n == MC_POINTS and not m3.skipped and (~m3.mask).sum() == n,
          f"Model3D.loadInvDir loaded {n} of {MC_POINTS} points, skipped "
          f"{m3.skipped}")
    vs50 = timed("genVsMap", m3.genVsMap, 50.0)
    check(int(np.isfinite(vs50.zMasked.filled(np.nan)).sum()) == MC_POINTS,
          "Model3D.genVsMap(50): not finite on every loaded node")
    prof = timed("vsProfile", m3.vsProfile, np.array([10.0, 50.0, 150.0]),
                 45.05, 228.05)
    check(prof.shape == (3,) and bool(np.isfinite(prof).all()),
          f"Model3D.vsProfile: {prof}")
    _, _, Z, moho, _ = timed("section", m3.section, 228.0, 45.0, 228.7,
                             45.7, y=np.linspace(0, 180, 19))
    check(Z.shape == (19, 301) and bool(np.isfinite(Z).any())
          and bool(np.isfinite(moho).any()), "Model3D.section: no values")
    qc = timed("checkPhaseVelocity", m3.checkPhaseVelocity, pers=[10, 50])
    check(set(qc) == {10, 50} and all(
        int(np.isfinite(qc[p]["resid_norm"].filled(np.nan)).sum())
        == MC_POINTS for p in qc), "Model3D.checkPhaseVelocity: maps")

    def fields(m, grid_props):
        """Each smoothed field stacked over the loaded nodes."""
        out = []
        for i, j in np.argwhere(~m.mask):
            mod = m.mods[i][j]
            out.append(np.array(mod.seisPropGrids(hLowerLimit=-1)[:-1])
                       if grid_props else np.asarray(mod._brownians()))
        return np.stack(out)

    errs = {}
    for name, kw in (("smooth", dict(width=50)),
                     ("smoothGrid", dict(width=50))):
        on_card, on_cpu = m3.copy(), m3.copy()
        on_cpu.device = "cpu"
        timed(name, getattr(on_card, name), **kw)
        getattr(on_cpu, name)(**kw)
        a, b = (fields(m, name == "smoothGrid") for m in (on_card, on_cpu))
        check(a.shape == b.shape and bool(np.isfinite(a).all()),
              f"Model3D.{name}: fields {a.shape} / {b.shape}")
        axes = tuple(range(a.ndim - 1)) if name == "smooth" else (0, 2)
        scale = np.abs(b).max(axis=axes)
        err = float((np.abs(a - b).max(axis=axes)
                     / np.where(scale > 0, scale, 1.0)).max())
        check(err <= 1e-12, f"Model3D.{name} on the card vs the CPU: "
              f"{err:.3e} of a field's max > 1e-12")
        errs[name] = err
    f = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_m3d_"), "m3.npz")
    timed("write", m3.write, f)
    back = Model3D(device=dev)
    timed("load", back.load, f)
    check(np.array_equal(back.genVsMap(50.0).zMasked.filled(np.nan),
                         vs50.zMasked.filled(np.nan), equal_nan=True),
          "Model3D write/load: the Vs map changed")
    log(f"[model3d] {n} of {MC_POINTS} points loaded ({len(m3.lats)} x "
        f"{len(m3.lons)} grid; {2 * n} single-model float64 solves); "
        f"seconds {json.dumps(secs)}; smoothing card vs CPU (of each "
        f"field's max) {json.dumps(errs)} ({card})")
    return dict(points=n, seconds=secs, smoothing_err=errs)


def sampler_size_times(sl, kern, sub, nlay, root, tk, wave, n_ill,
                       lane_model, card):
    """Each kernel's time at the sampler's lane count: K=18 (a row per
    period: the sign probe, the tangents, a refinement) and K=90 for
    secular_lanes (the fused warm sweep)."""
    import torch
    model = lane_model(sub, nlay, wave)
    zero = lambda x: torch.zeros(x.shape, dtype=torch.int32,  # noqa: E731
                                 device=x.device)
    _, _, mm = sl.secular_lanes(root + DC, tk, zero(root), *model, nlay,
                                wave=wave)
    c90, t90 = warm_sweep(root, tk)
    lo, hi, mmb = sweep_brackets(sl, root, tk, model, nlay, wave)
    calls = {
        "secular_lanes": lambda: sl.secular_lanes(root, tk, zero(root),
                                                  *model, nlay, wave=wave),
        "secular_lanes_k90": lambda: sl.secular_lanes(
            c90, t90, zero(c90), *model, nlay, wave=wave),
        "secular_lanes_frozen": lambda: sl.secular_lanes_frozen(
            root, tk, mm, *model, nlay, wave=wave),
        "secular_lanes_grad": lambda: sl.secular_lanes_grad(
            root, tk, mm, *model, nlay, wave=wave),
        "refine_lanes": lambda: sl.refine_lanes(
            lo, hi, tk, mmb, *model, nlay, wave=wave, n_ill=n_ill,
            n_newton=2),
    }
    for name, fn in calls.items():
        ms = time_cuda(fn, n=10)
        key = name if name.endswith("_k90") else name + "_sampler"
        kern[(key, wave)] = ms
        log(f"[time] {name.replace('_k90', '')} {wave} at the sampler's "
            f"size K={90 if name.endswith('_k90') else 18} "
            f"B={root.shape[1]}: kernel {ms:.4f} ms ({card})")


def ragged_check(sl, sub, nlay, root, tk, wave, n_ill, lane_model, card):
    """Every kernel bit for bit against its plain version at ragged
    shapes: B not a multiple of the kernels' 128-model blocks;
    secular_lanes (dynamic and pinned closures) and secular_lanes_grad at
    K = 1, 13 (a re-scan) and 90 (the sampler's fused warm sweep), rows
    from that sweep; secular_lanes_frozen (pinned) and refine_lanes
    (n_newton 0, 1 and 2, u on and off, brackets from a sweep around each
    root) at K = 1, 13 and 18 (a refinement)."""
    import torch
    model = lane_model(sub, nlay, wave)
    c90, t90 = warm_sweep(root, tk)
    _, _, pin90 = sl.secular_lanes(c90, t90, torch.zeros(c90.shape,
                                   dtype=torch.int32, device=c90.device),
                                   *model, nlay, wave=wave, backend="plain")
    lo18, hi18, mm18 = sweep_brackets(sl, root, tk, model, nlay, wave)
    for K in (1, 13, 18):
        c, t, pin = (x[:K].contiguous() for x in (c90, t90, pin90))
        same = bitwise(sl.secular_lanes_frozen(c, t, pin, *model, nlay,
                                               wave=wave),
                       sl.secular_lanes_frozen(c, t, pin, *model, nlay,
                                               wave=wave, backend="plain"))
        check(same, f"{wave} secular_lanes_frozen K={K} B={c.shape[1]} is "
              "not bitwise equal to its plain version")
        lo, hi, mm, t = (x[:K].contiguous() for x in (lo18, hi18, mm18, tk))
        for n_newton in (0, 1, 2):
            for group in (True, False):
                kr, pr = (sl.refine_lanes(lo, hi, t, mm, *model, nlay,
                                          wave=wave, n_ill=n_ill,
                                          n_newton=n_newton,
                                          compute_group=group, backend=b)
                          for b in ("auto", "plain"))
                check(bitwise(kr, pr), f"{wave} refine_lanes K={K} "
                      f"B={c.shape[1]} n_newton={n_newton} compute_group="
                      f"{group} is not bitwise equal to its plain version")
    shapes = []
    for K in (1, 13, 90):
        c, t, pin = (x[:K].contiguous() for x in (c90, t90, pin90))
        for kind, mmf in (("dynamic", torch.zeros_like(pin)),
                          ("pinned", pin)):
            same = bitwise(sl.secular_lanes(c, t, mmf, *model, nlay,
                                            wave=wave),
                           sl.secular_lanes(c, t, mmf, *model, nlay,
                                            wave=wave, backend="plain"))
            check(same, f"{wave} secular_lanes {kind} K={K} B={c.shape[1]}"
                  " is not bitwise equal to its plain version")
        same = bitwise(sl.secular_lanes_grad(c, t, pin, *model, nlay,
                                             wave=wave),
                       sl.secular_lanes_grad(c, t, pin, *model, nlay,
                                             wave=wave, backend="plain"))
        check(same, f"{wave} secular_lanes_grad K={K} B={c.shape[1]} is "
              "not bitwise equal to its plain version")
        shapes.append(f"K={K}")
    log(f"[kernels] {wave}: ragged B={c90.shape[1]} "
        f"{', '.join(shapes)}: secular_lanes (dynamic and pinned) and "
        f"secular_lanes_grad bitwise equal to their plain versions; K=1, 13,"
        f" 18: secular_lanes_frozen (pinned) and refine_lanes (n_ill "
        f"{n_ill}, n_newton 0, 1, 2, u on and off) bitwise equal too "
        f"({card})")


def compare_F(Fk, Fp, mask, what):
    """|dF| <= 1e-4 * max_k |F| per model column, equal signs above that
    bound; lanes outside ``mask`` (a different closure layer) excluded.
    Returns max |dF| over the compared lanes."""
    import torch
    bound = 1e-4 * Fp.abs().amax(dim=0, keepdim=True)
    sel = torch.ones_like(Fp, dtype=torch.bool) if mask is None else mask
    d = (Fk - Fp).abs()
    bad = sel & ~(d <= bound)
    check(not bool(bad.any()), f"{what}: |dF| above 1e-4 * max_k|F| on "
          f"{int(bad.sum())} lanes")
    big = sel & (Fp.abs() > bound)
    check(bool((torch.sign(Fk[big]) == torch.sign(Fp[big])).all()),
          f"{what}: sign of F differs")
    return float(d[sel].max())


def golden_check(surf_forward_batch, SurfConfig, dev, card):
    """The kernel path on the TEST1 eus model against its golden curves."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_helpers import GOLDEN, load_eus_model

    from pysurfinv_tpu_torch.convert import model_batch_from_numpy

    g = np.load(GOLDEN)
    m = load_eus_model()
    *args, nl = model_batch_from_numpy(
        *(m[k][None] for k in ("h", "vp", "vs", "rho", "qsinv")), m["nlay"],
        device=dev)
    per = torch.tensor(m["periods"], dtype=torch.float32, device=dev)
    for wave, wt in (("rayleigh", "R"), ("love", "L")):
        c, u, ok = surf_forward_batch(*args, per, nl, wave=wave,
                                      cfg=SurfConfig())
        ref_c, ref_u = g[f"phv_{wt}_0"][:, 1], g[f"grv_{wt}_0"][:, 1]
        check(bool(ok.all()), f"golden {wave}: not every period solved")
        ec = float(np.abs(c[0, :, 0].cpu().numpy() - ref_c).max()
                   / ref_c.max())
        eu = float(np.abs(u[0, :, 0].cpu().numpy() - ref_u).max()
                   / ref_u.max())
        # float32 roots: the JAX fast path in float32 reads 5.5e-5 (Love,
        # T = 10 s) on this model; 1e-4 is 10x inside the 0.1% north star
        check(ec < 1e-4, f"golden {wave}: phase error {ec:.3e} > 1e-4")
        log(f"[slice] TEST1 golden {wave} (float32 kernels): max phase "
            f"error {ec:.3e}, max group error {eu:.3e} of the curve's "
            f"maximum ({card})")


def joint_phase(sl, surf_forward_joint, arrs, periods, nl, cfg_r, cfg_l,
                out_r, out_l, card):
    """Phase 4b, first part: the joint solve on the phase-4 batch against
    phase 4's independent Rayleigh and Love solves.  Returns the joint
    path's launch counts."""
    import torch
    sl.reset_launch_counts()
    t0 = time.perf_counter()
    cR, uR, okR, cL, uL, okL = surf_forward_joint(
        *arrs, periods, nl, cfg=cfg_r, cfg_love=cfg_l, nsub=512)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in sl.KERNELS}
    for k in ("secular_lanes", "secular_lanes_frozen", "secular_lanes_grad"):
        check(launches[k] > 0, f"{k} was not launched on the joint path")
    love_same = bitwise((cL, uL), out_l[:2]) and torch.equal(okL, out_l[2])
    check(love_same, "joint Love outputs differ from the independent Love "
          "solve's")
    ok_curve = float(okR[:, :, 0].all(dim=1).float().mean())
    agree = float((okR == out_r[2]).float().mean())
    both = okR & out_r[2]
    d = (cR - out_r[0]).abs()
    close = float((d <= 1e-4)[both].float().mean())
    # lanes that differ, named (model, period index, |dc|), not hidden
    bad = (both & (d > 1e-4)) | (okR != out_r[2])
    where = bad[:, :, 0].nonzero()[:20].tolist()
    named = [(b, p, float(d[b, p, 0])) for b, p in where]
    du = (uR - out_r[1]).abs()[both].double()
    log(f"[joint] surf_forward_joint B={cR.shape[0]} P={cR.shape[1]} nsub "
        f"512: {sec:.3f} s first call; Love bitwise equal to the "
        f"independent solve {love_same}; Rayleigh ok {ok_curve:.5f} of "
        f"curves, ok agree {agree:.6f}, |dc| <= 1e-4 km/s on {close:.6f} of "
        f"lanes, max|dc| {float(d[both].max()):.3e}, q99|du| "
        f"{float(torch.quantile(du, 0.99)):.3e} km/s; {int(bad.sum())} lanes "
        f"differ (model, period, |dc|): {named}; launches {launches} "
        f"({card})")
    check(ok_curve >= 0.999, f"joint Rayleigh ok fraction {ok_curve:.5f}")
    check(agree >= 0.999, f"joint Rayleigh ok agreement {agree:.6f}")
    check(close >= 0.999, f"joint Rayleigh |dc| <= 1e-4 on {close:.6f}")
    return launches


# tests/test_dispersion_golden.py:40-46, 70 (that file imports JAX)
GRV_MEDIAN_TOL = {0: 1e-5, 1: 3e-5}


def phase_tol(golden, wt, mode):
    """Per-period phase tolerance of the TEST1 golden curves: 1e-3,
    widened where the golden file's own two columns disagree."""
    blk = golden[f"phv_{wt}_{mode}"]
    return np.maximum(1e-3, 2.0 * np.abs(blk[:, 1] - blk[:, 2]) / blk[:, 1])


def single_model_phase(arrs, nl, periods, out_r, dev, card):
    """Phase 4b, second part: the single-model float64 solve, ellipticity
    and amplitude, and the host inversion surface, on the card.  Returns
    their numbers."""
    import torch

    from pysurfinv_tpu_torch.inversion.point import (PointCascadia,
                                                     PostPointCascadia)
    from pysurfinv_tpu_torch.models.model1d import buildModel1D
    from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig,
                                                    surf_amplitude,
                                                    surf_ellipticity,
                                                    surf_forward)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_helpers import GOLDEN, load_eus_model

    f64 = dict(dtype=torch.float64, device=dev)
    res = {}

    def timed(fn, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # TEST1, nmodes 2, to the golden tolerances
    g, m = np.load(GOLDEN), load_eus_model()
    args = [torch.tensor(m[k], **f64)
            for k in ("h", "vp", "vs", "rho", "qsinv")]
    per = torch.tensor(m["periods"], **f64)
    for wave, wt in (("rayleigh", "R"), ("love", "L")):
        (c, u, ok), sec = timed(surf_forward, *args, per, m["nlay"],
                                wave=wave, cfg=SurfConfig(nmodes=2))
        check(c.is_cuda and c.dtype == torch.float64,
              f"single-model {wave}: output {c.dtype} on {c.device}")
        c, u, ok = (x.cpu().numpy() for x in (c, u, ok))
        errs = []
        for mode in (0, 1):
            refc = g[f"phv_{wt}_{mode}"][:, 1]
            refu = g[f"grv_{wt}_{mode}"][:, 1]
            tol = phase_tol(g, wt, mode)
            rc = np.abs(c[:, mode] - refc) / refc
            ru = np.abs(u[:, mode] - refu) / refu
            check(ok[:, mode].all() and (rc < tol).all()
                  and np.median(rc) < 1e-6 and (ru < 10 * tol).all()
                  and np.median(ru) < GRV_MEDIAN_TOL[mode],
                  f"single-model TEST1 {wave} mode {mode}: phase rel err "
                  f"{rc.max():.3e} (median {np.median(rc):.3e}), group "
                  f"{ru.max():.3e} (median {np.median(ru):.3e})")
            errs.append((rc.max(), np.median(ru)))
        ec = np.abs(c[:, 0] - g[f"phv_{wt}_0"][:, 1]).max() \
            / g[f"phv_{wt}_0"][:, 1].max()
        eu = np.abs(u[:, 0] - g[f"grv_{wt}_0"][:, 1]).max() \
            / g[f"grv_{wt}_0"][:, 1].max()
        check(ec < 1e-5 and eu < 5e-5, f"single-model TEST1 {wave}: "
              f"fundamental phase {ec:.3e} of max (1e-5), group {eu:.3e} "
              "(5e-5)")
        res[f"test1_{wave}_nmodes2_s"] = round(sec, 3)
        log(f"[single] surf_forward float64 TEST1 {wave} nmodes 2, "
            f"{len(m['periods'])} periods: {sec:.3f} s; fundamental phase "
            f"{ec:.3e}, group {eu:.3e} of max; mode 1 max phase rel err "
            f"{errs[1][0]:.3e}, median group rel err {errs[1][1]:.3e} "
            f"({card})")

    # model 0 of the bench batch against the kernel solve; the default
    # config (nbisect 12) converges the float64 root, cfg_r's 8 Illinois
    # iterations leave up to ~7e-5 km/s
    b0 = [a[0].to(torch.float64) for a in arrs]
    p64 = periods.to(torch.float64)
    secs = []
    for _ in range(2):  # the second call is the time per curve
        (c0, _, ok0), sec = timed(surf_forward, *b0, p64, int(nl[0]),
                                  wave="rayleigh", cfg=SurfConfig())
        secs.append(sec)
    ok_k = out_r[2][0, :, 0]
    dc = float((c0[:, 0] - out_r[0][0, :, 0].double()).abs().max())
    check(bool(ok0[:, 0].all()) and torch.equal(ok0[:, 0], ok_k)
          and dc <= 1e-4, f"single-model bench model 0: ok "
          f"{ok0[:, 0].tolist()} against {ok_k.tolist()}, max|dc| {dc:.3e}")
    res["s_per_curve"] = round(secs[1], 3)
    res["first_call_s"] = round(secs[0], 3)
    log(f"[single] surf_forward float64 bench model 0 (L={b0[0].shape[0]}, "
        f"{len(p64)} periods, Rayleigh, phase + group): {secs[1]:.3f} s per "
        f"curve (first call {secs[0]:.3f} s); max|dc| against the kernel "
        f"solve {dc:.3e} km/s ({card})")

    # ellipticity on a uniform Poisson halfspace (tests/test_eigen.py)
    L, vs0 = 8, 3.0
    hs = (torch.zeros(L, **f64), torch.full((L,), vs0 * 3 ** 0.5, **f64),
          torch.full((L,), vs0, **f64), torch.full((L,), 2.7, **f64),
          torch.zeros(L, **f64))
    per_hs = torch.tensor([5.0, 10.0, 20.0, 50.0], **f64)
    ell, c_hs, ok_hs = surf_ellipticity(
        *hs, per_hs, 2, cfg=SurfConfig(atten=False, flat=False))
    ell = ell[:, 0].abs().cpu().numpy()
    c_rel = float((c_hs[:, 0] / (0.9194 * vs0) - 1).abs().max())
    spread = float(ell.std() / ell.mean())
    check(bool(ok_hs.all()) and c_rel < 2e-3 and spread < 1e-3
          and abs(ell.mean() - 0.681) < 0.02,
          f"Poisson halfspace: c rel err {c_rel:.3e}, H/V {ell.tolist()}")
    (amp, _, ok_a), sec = timed(surf_amplitude, *args, per, m["nlay"])
    amp, ok_a = amp.cpu().numpy()[:, 0], ok_a.cpu().numpy()[:, 0]
    check(ok_a.any() and np.isfinite(amp).all() and (amp[ok_a] > 0).all(),
          f"surf_amplitude TEST1: {amp.tolist()}")
    log(f"[single] surf_ellipticity Poisson halfspace: c/(0.9194 beta) - 1 "
        f"max {c_rel:.3e}, H/V {float(ell.mean()):.5f} (spread "
        f"{spread:.2e}); surf_amplitude TEST1 ({sec:.3f} s): finite, "
        f"positive on {int(ok_a.sum())}/{len(ok_a)} solved periods ({card})")

    # the host inversion surface on the reference's example point, each
    # entry point on its default device (the card)
    mod = buildModel1D(MC_SETTING, dict(MC_LOCAL))
    pred, sec = timed(mod.forward, PERIODS)
    check(pred is not None and np.isfinite(pred).all()
          and ((pred > 3) & (pred < 5)).all(),
          f"Model1D.forward on the example point: {pred}")
    pt = PointCascadia(MC_SETTING, dict(MC_LOCAL), periods=PERIODS,
                       vels=MC_VELS, uncers=MC_UNCERS)
    mis = pt.misfit()
    check(np.isfinite(mis).all() and mis[0] < 88888,
          f"PointCascadia.misfit: {mis}")
    log(f"[single] Model1D.forward (18 periods, {sec:.3f} s) c in "
        f"[{pred.min():.4f}, {pred.max():.4f}] km/s; PointCascadia.misfit "
        f"{float(mis[0]):.5f} ({card})")
    p5 = PointCascadia(MC_SETTING, dict(MC_LOCAL), periods=PERIODS[::4],
                       vels=MC_VELS[::4], uncers=MC_UNCERS[::4])
    out = tempfile.mkdtemp(prefix="chip_smoke_mcinv_")
    _, sec = timed(p5.MCinv, outdir=out, pid="p", runN=4, chainL=2, seed=0)
    npz = os.path.join(out, "p.npz")
    check(os.path.exists(npz), "Point.MCinv wrote no npz")
    track = np.load(npz, allow_pickle=True)["mcTrack"]
    check(track.shape[0] == 4 and np.isfinite(track).all()
          and (track[:, 0] < 88888).all(), f"Point.MCinv track {track}")
    post = PostPointCascadia(npz)
    check(np.isfinite(post.avgMod.misfit) and post.accFinal.any(),
          f"PostPoint avgMod misfit {post.avgMod.misfit}")
    res["mcinv_4_steps_s"] = round(sec, 3)
    log(f"[single] Point.MCinv runN 4 chainL 2, 5 periods: {sec:.3f} s, "
        f"misfits {track[:, 0].round(5).tolist()}, accepts "
        f"{track[:, 2].tolist()}; PostPoint avgMod misfit "
        f"{float(post.avgMod.misfit):.5f}, threshold {post.thres:.5f} "
        f"({card})")
    return res


# tests/test_kernels.py:74, 89, 105 (that file imports JAX): AD against
# central finite differences, phase and group; apparent Q against TEST1
FD_PHASE_TOL, FD_GROUP_TOL, Q_APP_TOL = 2e-5, 3e-3, 2e-2
# tests/test_eigen.py:141-151, 219-240: profiles against the TEST1 depth
# tables (values, spherical-depth derivatives), the energy integrals, the
# integral-path u, the variational c and the Lagrangian residual
EIG_TOL, DEIG_TOL = 1e-4, 5e-3
INT_TOL, U_INT_TOL, C_VAR_TOL, FLAGR_TOL = 1e-4, 1e-5, 1e-6, 1e-4
# tests/test_kernel_density_golden.py:39-41, 34: density ceilings in units
# of the golden column's max, above DEPTH_CAP km excluded
KPHV_TOL, KGRV_TOL, DEPTH_CAP = {0: 0.01, 1: 0.02}, 0.02, 200.0
# the card's analysis against the same call on the host's CPU; the group
# kernels are second derivatives, whose rounding the two libms move more
# (du_dvp, the smallest, 2.27e-9 on an H100; JAX and the port differ by
# 1.01e-9 on one CPU)
CPU_TOL, CPU_TOL_GROUP = 1e-9, 1e-8
ANALYSIS_PERIODS = [10.0, 30.0, 60.0]
FD_LAYERS = [5, 17, 30, 50]


def golden_roots(g, wt, periods):
    """(P, 2) phase velocities of the TEST1 eigenfunction headers, -1
    where the golden has no table (mode 1 at its missing periods)."""
    cg = np.full((len(periods), 2), -1.0)
    for mode in (0, 1):
        for ip, T in enumerate(int(t) for t in periods):
            key = f"eig_{wt}_{mode}_{T}_hdr"
            if key in g.files:
                cg[ip, mode] = g[key][1]
    return cg


def analysis_phase(dev, card):
    """Phase 4c: the analysis surface in float64 on the card — the
    sensitivity kernels against finite differences of the port's own
    solve and against the same call on the CPU, apparent Q, the
    eigenfunctions, energy integrals and kernel densities against the
    TEST1 goldens, and the user-facing classes.  Returns seconds per
    call.  (R mode 1 at T = 20 s is excluded throughout, as the golden
    tests exclude it: the golden root sits ~9e-4 off the secular root at
    the R1/R2 osculation.)"""
    import torch

    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward
    from pysurfinv_tpu_torch.ops.eigen import (eigenfunctions_regular,
                                               energy_integrals)
    from pysurfinv_tpu_torch.ops.kernels import (kernel_densities,
                                                 sensitivity_kernels)
    from pysurfinv_tpu_torch.senskernel import SensKernel, SensKernelPert
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_helpers import GOLDEN, load_eus_model

    g, m = np.load(GOLDEN), load_eus_model()
    keys = ("h", "vp", "vs", "rho", "qsinv")
    res = {}

    def args_on(device, model=m):
        return [torch.tensor(np.asarray(model[k]), dtype=torch.float64,
                             device=device) for k in keys]

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    # the classes run on their default device, the card (a host run of
    # this phase names the CPU)
    dkw = {} if dev.type == "cuda" else {"device": dev.type}

    def timed(name, fn, *a, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        res[name] = round(time.perf_counter() - t0, 3)
        return out

    def on_card(x):
        check(x.device.type == dev.type
              and x.dtype in (torch.float64, torch.bool),
              f"analysis output {x.dtype} on {x.device}")
        return x.cpu().numpy()

    per = ANALYSIS_PERIODS
    gold_rows = [int(t) // 10 - 1 for t in per]
    fd_cfg = SurfConfig(nmodes=1, nbisect=30)
    a_dev = args_on(dev)
    t_dev = torch.tensor(per, dtype=torch.float64, device=dev)
    for wave, wt in (("rayleigh", "R"), ("love", "L")):
        # 1. phase and group kernels against central FD of the solve
        kr = timed(f"sensitivity_kernels_{wave}_s", sensitivity_kernels,
                   *a_dev, t_dev, m["nlay"], wave=wave, cfg=fd_cfg)
        kr = {k: on_card(v) for k, v in kr._asdict().items()}
        check(kr["valid"].all(), f"sensitivity_kernels {wave}: valid "
              f"{kr['valid'].tolist()}")
        errs = {}
        t0 = time.perf_counter()
        for which in ("vs", "vp", "rho"):
            if wave == "love" and which == "vp":
                continue
            dc, du = [], []
            for i in FD_LAYERS:
                cu = []
                for sgn in (1, -1):
                    pert = {k: np.array(m[k], np.float64) for k in keys}
                    step = 1e-3 * pert[which][i]
                    pert[which][i] += sgn * step
                    c, u, ok = surf_forward(*args_on(dev, pert), t_dev,
                                            m["nlay"], wave=wave, cfg=fd_cfg)
                    check(bool(ok.all()), f"FD solve {wave} {which} {i}")
                    cu.append((on_card(c)[:, 0], on_card(u)[:, 0], step))
                (cp, up, s), (cm, um, _) = cu
                dc.append((cp - cm) / (2 * s))
                du.append((up - um) / (2 * s))
            dc, du = np.array(dc).T, np.array(du).T
            e_c = (np.abs(kr["dc_d" + which][:, FD_LAYERS] - dc).max()
                   / (np.abs(dc).max() + 1e-12))
            errs["dc_d" + which] = e_c
            check(e_c < FD_PHASE_TOL, f"{wave} dc_d{which} vs FD: {e_c:.3e} "
                  f"of scale > {FD_PHASE_TOL}")
            if which != "vp":
                e_u = (np.abs(kr["du_d" + which][:, FD_LAYERS] - du).max()
                       / (np.abs(du).max() + 1e-12))
                errs["du_d" + which] = e_u
                check(e_u < FD_GROUP_TOL, f"{wave} du_d{which} vs FD: "
                      f"{e_u:.3e} of scale > {FD_GROUP_TOL}")
        res[f"fd_{wave}_s"] = round(time.perf_counter() - t0, 3)
        # 2. the same call on CPU tensors
        t0 = time.perf_counter()
        kc = sensitivity_kernels(*args_on("cpu"), torch.tensor(per),
                                 m["nlay"], wave=wave, cfg=fd_cfg)
        res[f"sensitivity_kernels_{wave}_cpu_s"] = round(
            time.perf_counter() - t0, 3)
        cpu_err = {}
        for k, v in kc._asdict().items():
            v = v.numpy()
            if v.dtype == bool:
                check(np.array_equal(v, kr[k]), f"{wave} {k}: CPU vs card")
                continue
            cpu_err[k] = np.abs(v - kr[k]).max() / max(np.abs(v).max(), 1e-300)
        log(f"[analysis] sensitivity_kernels {wave}: card vs CPU, of each "
            "field's max: " + ", ".join(f"{k} {e:.2e}"
                                        for k, e in cpu_err.items()))
        for k, e in cpu_err.items():
            tol = CPU_TOL_GROUP if k.startswith("du_") else CPU_TOL
            check(e <= tol, f"{wave} {k}: card vs CPU {e:.3e} of max > {tol}")
        # 3. apparent Q against the TEST1 goldens
        ref_q = g[f"att_{wt}_0"][gold_rows, 1]
        e_q = float((np.abs(kr["q_app"] - ref_q) / ref_q).max())
        check(e_q < Q_APP_TOL, f"{wave} q_app vs golden {e_q:.3e}")
        log(f"[analysis] sensitivity_kernels {wave} T={per} (float64, "
            f"{res[f'sensitivity_kernels_{wave}_s']:.3f} s; CPU "
            f"{res[f'sensitivity_kernels_{wave}_cpu_s']:.3f} s): AD vs FD "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" of scale ({res[f'fd_{wave}_s']:.1f} s of FD solves); card "
            f"vs CPU {max(cpu_err.values()):.2e} of max; q_app vs golden "
            f"{e_q:.2e} ({card})")
    for wave in ("rayleigh", "love"):
        k2 = timed(f"sensitivity_kernels_{wave}_nmodes2_s",
                   sensitivity_kernels, *a_dev, t_dev, m["nlay"], wave=wave,
                   cfg=SurfConfig(nmodes=2))
        k2 = {k: on_card(v) for k, v in k2._asdict().items()}
        check(k2["dc_dvs"].shape == (len(per), 2, len(m["h"]))
              and k2["valid"].all()
              and all(np.isfinite(v).all() for v in k2.values()),
              f"sensitivity_kernels {wave} nmodes 2: valid "
              f"{k2['valid'].tolist()}")
    log(f"[analysis] sensitivity_kernels nmodes 2, group: Rayleigh "
        f"{res['sensitivity_kernels_rayleigh_nmodes2_s']:.3f} s, Love "
        f"{res['sensitivity_kernels_love_nmodes2_s']:.3f} s, all lanes "
        f"valid and finite ({card})")

    # 4. eigenfunctions and energy integrals at the golden roots
    per_g = [float(t) for t in m["periods"]]
    t_g = torch.tensor(per_g, dtype=torch.float64, device=dev)
    cfg2 = SurfConfig(nmodes=2)
    for wave, wt in (("rayleigh", "R"), ("love", "L")):
        cg = torch.tensor(golden_roots(g, wt, per_g), device=dev)
        reg = timed(f"eigenfunctions_regular_{wave}_s",
                    eigenfunctions_regular, *a_dev, t_g, m["nlay"],
                    wave=wave, cfg=cfg2, dz=2.0, nz=500, c_given=cg)
        reg = {k: on_card(v) for k, v in reg.items()}
        ei = timed(f"energy_integrals_{wave}_s", energy_integrals, *a_dev,
                   t_g, m["nlay"], wave=wave, cfg=cfg2, c_given=cg)
        ei = {k: on_card(v) for k, v in ei.items()}
        comps = ("v1", "v2") if wt == "R" else ("v1",)
        names = ("I0", "I1", "I2", "I3") if wt == "R" else ("I0", "I1", "I2")
        worst = dict(eig=0.0, deig=0.0, ints=0.0, u_int=0.0, c_var=0.0,
                     flagr=0.0)
        n_prof = 0
        for mode in (0, 1):
            for ip, T in enumerate(int(t) for t in per_g):
                if wt == "R" and mode == 1 and T == 20:
                    continue
                for comp in comps:
                    key = f"eig_{wt}_{mode}_{T}_{comp}"
                    if key not in g.files:
                        continue
                    ref = g[key]
                    sel = ref[:, 0] <= reg["z"][-1] + 1e-9
                    ii = np.round(ref[sel, 0] / 2.0).astype(int)
                    for col, name, tol in ((1, "eig", EIG_TOL),
                                           (2, "deig", DEIG_TOL)):
                        src = reg[comp] if col == 1 else reg["d" + comp]
                        ours = src[ip, mode][ii]
                        vref = ref[sel, col]
                        sign = np.sign(ours[0] * vref[0]) or 1.0
                        e = (np.abs(sign * ours - vref).max()
                             / np.abs(ref[:, col]).max())
                        worst[name] = max(worst[name], e)
                        check(e < tol, f"{key} col {col}: {e:.3e} > {tol}")
                    n_prof += 1
                gi = g[f"eig_{wt}_{mode}_{T}_int"]
                for j, nm in enumerate(names):
                    e = abs(ei[nm][ip, mode] - gi[j]) / abs(gi[j])
                    worst["ints"] = max(worst["ints"], e)
                    check(e < INT_TOL, f"{wt} m{mode} T={T} {nm}: {e:.3e}")
                u_g = g[f"grv_{wt}_{mode}"][ip, 1]
                e = abs(ei["u_int"][ip, mode] - u_g) / u_g
                worst["u_int"] = max(worst["u_int"], e)
                check(e < U_INT_TOL, f"{wt} m{mode} T={T} u_int: {e:.3e}")
                cv_g = g[f"phv_{wt}_{mode}"][ip, 2]
                e = abs(ei["c_var"][ip, mode] - cv_g) / cv_g
                worst["c_var"] = max(worst["c_var"], e)
                check(e < C_VAR_TOL, f"{wt} m{mode} T={T} c_var: {e:.3e}")
                if not (mode == 1 and T == 20):
                    om2I0 = (2 * np.pi / T) ** 2 * ei["I0"][ip, mode]
                    e = abs(ei["flagr"][ip, mode]) / om2I0
                    worst["flagr"] = max(worst["flagr"], e)
                    check(e < FLAGR_TOL, f"{wt} m{mode} T={T} flagr {e:.3e}")
        check(n_prof >= 20, f"{wave}: only {n_prof} golden profiles held")
        log(f"[analysis] eigenfunctions_regular "
            f"({res[f'eigenfunctions_regular_{wave}_s']:.3f} s) and "
            f"energy_integrals ({res[f'energy_integrals_{wave}_s']:.3f} s) "
            f"{wave}, nmodes 2 at the golden roots, {n_prof} profiles: "
            "worst " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f" ({card})")

        # 5. kernel densities against the golden tables
        t0 = time.perf_counter()
        dens = kernel_densities(*a_dev, t_g, m["nlay"], wave=wave, cfg=cfg2,
                                dz=2.0, nz=500, group=True, c_given=cg)
        res[f"kernel_densities_{wave}_s"] = round(time.perf_counter() - t0, 3)
        cols = ("Kvs", "Kvp", "Krho") if wt == "R" else ("Kvs", "Krho")
        n_cols, worst_k = 0, {"phv": 0.0, "grv": 0.0}
        for kind_, modes in (("phv", (0, 1)), ("grv", (0,))):
            names_k = cols if kind_ == "phv" else tuple(
                "G" + c[1:] for c in cols if c != "Krho")
            for mode in modes:
                tol = KPHV_TOL[mode] if kind_ == "phv" else KGRV_TOL
                for ip, T in enumerate(int(t) for t in per_g):
                    key = f"k{kind_}_{wt}_{mode}_{T}"
                    if (wt == "R" and mode == 1 and T == 20) or \
                            key not in g.files:
                        continue
                    arr = g[key]
                    sel = (arr[:, 0] <= DEPTH_CAP) & (arr[:, 0] > 0)
                    ii = np.round(arr[sel, 0] / 2.0).astype(int)
                    for icol, name in enumerate(names_k):
                        ours = dens[name][ip, mode][ii]
                        e = (np.abs(ours - arr[sel, 1 + icol]).max()
                             / np.abs(arr[:, 1 + icol]).max())
                        worst_k[kind_] = max(worst_k[kind_], e)
                        check(e < tol, f"{key} {name}: {e:.3e} > {tol}")
                        n_cols += 1
        check(n_cols >= 10 * len(cols), f"{wave}: {n_cols} density columns")
        log(f"[analysis] kernel_densities {wave} group=True "
            f"({res[f'kernel_densities_{wave}_s']:.3f} s), {n_cols} golden "
            f"columns: worst phase {worst_k['phv']:.2e}, group "
            f"{worst_k['grv']:.2e} of the golden max ({card})")

    # 6. the user-facing classes on a dict model, on the card by default
    model = {"H": g["model_h"], "Vp": g["model_vp"], "Vs": g["model_vs"],
             "Rho": g["model_rho"], "Qs": g["model_qs"]}
    kw = dict(wtype="R", Tmin=10, Tmax=60, Tstep=10, endmode=1)
    for method in ("ad", "eigen"):
        sk = timed(f"senskernel_{method}_s", SensKernel, model=dict(model),
                   method=method, **kw, **dkw)
        solved = sk.c > 0                                   # (nper, M)
        fin = all(np.isfinite(k[mode, :, ip]).all()
                  for k in (sk.kernel_phv, sk.kernel_grv)
                  for ip, mode in zip(*np.nonzero(solved)))
        check(solved.all() and fin, f"SensKernel {method}: solved "
              f"{solved.tolist()}, finite where solved {fin}")
        log(f"[analysis] SensKernel(method={method!r}) 68 layers, T 10-60 s, "
            f"endmode 1: {res[f'senskernel_{method}_s']:.3f} s, kernel_phv "
            f"{sk.kernel_phv.shape} finite ({card})")
    top = {k: np.asarray(v, float)[:12].copy() for k, v in model.items()}
    pk = timed("senskernel_pert_s", SensKernelPert, model=top, wtype="R",
               Tmin=10, Tmax=60, Tstep=10, **dkw)
    check(sorted(pk.kernel) == ["Vp", "Vs"]
          and all(np.isfinite(v).all() and np.abs(v).max() > 0
                  for v in pk.kernel.values()),
          "SensKernelPert: kernels not finite")
    log(f"[analysis] SensKernelPert first 12 layers, T 10-60 s: "
        f"{res['senskernel_pert_s']:.3f} s ({2 * 2 * 12} single-model "
        f"solves), Vs and Vp kernels finite ({card})")
    return res


if __name__ == "__main__":
    main()

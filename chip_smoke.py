#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's two main paths through the entry points a user calls:

  * the batched dispersion solve ``surf_forward_batch`` at the headline
    workload of bench.py: the 86-layer Cascadia-ocean model padded to
    L=88, built through the port's own model layer, 65,536 models
    (+-0.5% Vs/Vp jitter, seed 0), 18 periods, Rayleigh and Love, the
    MCMC sampler's warm re-solve, and the refinement in one
    ``refine_lanes`` launch (``nnewton=2``, ``fuse_illinois``);
  * the batched MCMC sampler ``invert_grid`` at the JAX package's
    flagship workload (bench.py:249-260): 64 PointCascadia points of the
    reference's example setting (examples/invert_point.py:21-51),
    sedthk and lithoAge from default_rng(0), runN 6000 with chainL 200
    (1,920 lanes), 18 periods, segment 100, seed 1 — with the default
    solver (newton_sep 3) and with ``PYSURFINV_MCMC_NNEWTON=2``.

Phases, each of which raises on failure:

  1. card     the card's name and power limit (nvidia-smi) — no CPU
              fallback: without CUDA the script exits non-zero;
  2. build    the four secular-lane kernels, built with nvcc from csrc/,
              with each kernel's registers and spills from ptxas;
  3. kernels  each kernel against its plain PyTorch version on the card,
              at main-path lane shapes (K=33 cold sweep, K=18 refinement
              and tangents, B=4096): |dF| <= 1e-4 * max_k |F| per model
              column, F_T/F_c to 2e-3 relative, b_hs and mm equal on
              >= 99.99% of lanes; refine_lanes on brackets from a sweep
              around each lane's root, n_newton 2 (with u) and 0 (the
              fuse_illinois form): |droot| <= 1e-4 km/s on >= 99.99% of
              lanes, u within 1e-3 relative at q99; whether each kernel
              is bitwise equal to its plain version is recorded, and
              secular_lanes and secular_lanes_grad must be, there and at
              ragged shapes (B=4095; K=1, 13 and 90; dynamic and pinned
              closures);
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
  5. sampler  on 2 points x 4 chains x 10 steps the sampler with the
              kernels gives the tracks of the sampler with the plain
              versions; then the flagship workload twice with the default
              solver (the second call timed:
              mcmc_effective_solves_per_sec = 64 * 6000 / seconds) and
              once with PYSURFINV_MCMC_NNEWTON=2 (NEWTON_SEP=0, which the
              variable needs to take effect): every npz written, every
              misfit finite, the acceptance rate printed, the expected
              launch counters moved; a torch.profiler trace (CUDA
              activity) of a 6-row run gives the device idle share;
  6. time     solves/s per run, each kernel's time beside its plain
              version's and its bound, and at the sampler's size (B=1,920,
              K=18; K=90 for secular_lanes, the fused warm sweep),
              refine_lanes beside the separate frozen + gradient launches
              it replaces (CUDA events for kernels, best of 3 windows
              after a warm-up; host clock around synchronised solves).

Prints the card line and a JSON line of per-kernel results before the
last line, ``{"ok": true, "device": {...}}``.  Run from the repository
root: ``python3 chip_smoke.py``.
"""

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
MC_POINTS, MC_RUN_N, MC_CHAIN_L, MC_SEGMENT, MC_SEED = 64, 6000, 200, 100, 1
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
# the kernels' symbols in the ptxas report, and the H100's register file
# (65,536 a SM, allocated 256 a warp; at most 64 warps and 32 blocks a SM)
PTXAS_NAMES = {"secular_lanes": "secular_lanes_kernel",
               "secular_lanes_frozen": "secular_frozen_kernel",
               "secular_lanes_grad": "secular_grad_kernel",
               "refine_lanes": "refine_kernel"}
BLOCK = 128


def bound(nbytes, ops):
    """(bound_ms, bound_by) of a launch that moves ``nbytes`` and does
    ``ops`` operations."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def ptxas_usage(report):
    """{(kernel, wave): (registers, spill-store bytes)} from nvcc's
    ``-Xptxas -v`` report (template argument true = Rayleigh)."""
    usage, name, spill = {}, None, 0
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = None
            for k, sym in PTXAS_NAMES.items():
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
    from pysurfinv_tpu_torch.ops import secular_lanes as sl
    from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _illinois,
                                                    _initial_c,
                                                    surf_forward_batch)
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
    check(len(usage) == 2 * len(REPLACES),
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
        for name in ("secular_lanes", "secular_lanes_grad"):
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
                     tk[:, :B_LANES - 1].contiguous(), wave, lane_model, card)

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
    out_f = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_f)
    torch.cuda.synchronize()
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

    # ---- 5. the sampler ----------------------------------------------
    launches_mc, mc = sampler_phase(sl, card)

    # ---- 6. time -----------------------------------------------------
    solves = {}
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
        log(f"[time] {name}: {best * 1e3:.2f} ms per {B_SLICE}-model "
            f"18-period solve, {B_SLICE / best:.1f} solves/s ({card})")

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
            pms = time_cuda(lambda: fn("plain"), n=1)
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
        log(f"[time] refine_lanes {wave} one launch {kern[('refine_lanes', wave)][0]:.3f} "
            f"ms vs the separate launches it replaces ({n_ill + 2} "
            f"secular_lanes_frozen + 2 secular_lanes_grad + glue) "
            f"{sep_ms:.3f} ms ({card})")
        sampler_size_times(sl, kern, [a[:B_SAMPLER] for a in arrs],
                           nl[:B_SAMPLER], root[:, :B_SAMPLER].contiguous(),
                           tk[:, :B_SAMPLER].contiguous(), wave, n_ill,
                           lane_model, card)

    kernels = []
    for name, rep in REPLACES.items():
        ms, pms, bms, bby = kern[(name, "rayleigh")]
        lms, lpms, lbms, _ = kern[(name, "love")]
        extra = {k: v for k, v in kerr[name].items() if k != "max_abs_err"}
        if name == "refine_lanes":
            extra.update(separate_launches_ms=kern[("separate_2_3",
                                                    "rayleigh")],
                         love_separate_launches_ms=kern[("separate_2_3",
                                                         "love")])
        if name == "secular_lanes":
            extra.update(sampler_k90_ms={
                w: kern[("secular_lanes_k90", w)] for w in waves})
        regs = {w: usage[(name, w)][0] for w in waves}
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=rep,
            launches=launches_solve[name] + launches_mc[name],
            max_abs_err=kerr[name]["max_abs_err"],
            ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
            library_ms=None,
            launches_solve_path=launches_solve[name],
            launches_sampler_path=launches_mc[name],
            love_ms=lms, love_plain_ms=lpms, love_bound_ms=lbms,
            shape=f"K={33 if name == 'secular_lanes' else 18},B={B_SLICE},"
                  f"L={L}", bitwise=bits[name], registers=regs,
            spill_bytes={w: usage[(name, w)][1] for w in waves},
            occupancy={w: occupancy(r) for w, r in regs.items()},
            sampler_ms={w: kern[(name + "_sampler", w)] for w in waves},
            **extra))

    log(f"[time] summary ({card}): solves/s " + json.dumps(
        {k: round(v, 1) for k, v in solves.items()}) + "; sampler " +
        json.dumps(mc) + f"; chip_smoke {time.perf_counter() - t_start:.1f} s")
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
    sampler path's launch counts (every run summed) and its numbers."""
    import torch
    from unittest import mock

    from pysurfinv_tpu_torch.parallel import grid

    out = tempfile.mkdtemp(prefix="chip_smoke_mc_")
    pts, lls = mc_points(MC_POINTS)
    lanes = MC_POINTS * (MC_RUN_N // MC_CHAIN_L)

    # kernels against plain versions, through the whole sampler: 2 points
    # x 4 chains x 10 steps
    cfg0 = grid.mcmc_solver_cfg
    sub = {}
    for backend in ("auto", "plain"):  # auto: the kernels, on the card
        with mock.patch.object(grid, "mcmc_solver_cfg",
                               lambda b=backend: replace(cfg0(), backend=b)):
            paths = grid.invert_grid(pts[:2], lls[:2],
                                     outdir=f"{out}/sub_{backend}", runN=40,
                                     chainL=10, seed=MC_SEED, segment=5,
                                     verbose=False)
        sub[backend] = read_tracks(paths)
    a, b = sub["auto"], sub["plain"]
    same_theta = bool(np.array_equal(a[..., 2:], b[..., 2:]))
    dmis = float(np.abs(a[..., 0] - b[..., 0]).max())
    check(same_theta and dmis <= 1e-6 * float(np.abs(b[..., 0]).max()),
          f"sampler tracks with the kernels differ from the plain "
          f"versions' (thetas/accepts equal {same_theta}, max|dmisfit| "
          f"{dmis:.3e})")
    log(f"[sampler] 2 points x 4 chains x 10 steps: kernels vs plain "
        f"versions: thetas and accepts equal {same_theta}, max|dmisfit| "
        f"{dmis:.3e}, bitwise {bool(np.array_equal(a, b))} ({card})")

    launches = {k.__name__: 0 for k in sl.KERNELS}
    res = {}
    runs = (("default_first_call", {}), ("default", {}),
            ("nnewton2", {"PYSURFINV_MCMC_NNEWTON": "2",
                          "PYSURFINV_MCMC_NEWTON_SEP": "0"}))
    for name, env in runs:
        sl.reset_launch_counts()
        with mock.patch.dict(os.environ, env):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            paths = grid.invert_grid(pts, lls, outdir=f"{out}/{name}",
                                     runN=MC_RUN_N, chainL=MC_CHAIN_L,
                                     seed=MC_SEED, segment=MC_SEGMENT,
                                     verbose=False)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        got = {k.__name__: k.launches for k in sl.KERNELS}
        for k, n in got.items():
            launches[k] += n
        need = (("secular_lanes", "refine_lanes") if name == "nnewton2"
                else ("secular_lanes", "secular_lanes_frozen",
                      "secular_lanes_grad"))
        for k in need:
            check(got[k] > 0, f"sampler run {name}: {k} was not launched")
        if name == "nnewton2":
            check(got["secular_lanes_grad"] == 0,
                  "sampler run nnewton2 still took the newton_sep path")
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
                         acceptance=round(acc, 4), failed_rows=fails)
        log(f"[sampler] {name}: {MC_POINTS} points x {MC_RUN_N // MC_CHAIN_L}"
            f" chains x {MC_CHAIN_L} steps ({lanes} lanes): {sec:.2f} s, "
            f"{rate:.1f} effective solves/s, acceptance {acc:.4f}, "
            f"{fails} rows with a failed solve, min misfit "
            f"{float(tr[..., 0].min()):.4f}, launches {got} ({card})")
    log(f"[sampler] mcmc_effective_solves_per_sec (second call, newton_sep"
        f" 3): {res['default']['solves_per_sec']}; first call "
        f"{res['default_first_call']['seconds']} s; nnewton2 "
        f"{res['nnewton2']['solves_per_sec']} ({card})")

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
    return launches, res


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


def ragged_check(sl, sub, nlay, root, tk, wave, lane_model, card):
    """secular_lanes (dynamic and pinned closures) and secular_lanes_grad
    bit for bit against their plain versions at ragged shapes: B not a
    multiple of the kernels' 128-model blocks, K = 1, 13 (a re-scan) and
    90 (the sampler's fused warm sweep), rows from that sweep."""
    import torch
    model = lane_model(sub, nlay, wave)
    c90, t90 = warm_sweep(root, tk)
    _, _, pin90 = sl.secular_lanes(c90, t90, torch.zeros(c90.shape,
                                   dtype=torch.int32, device=c90.device),
                                   *model, nlay, wave=wave, backend="plain")
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
        f"secular_lanes_grad bitwise equal to their plain versions ({card})")


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


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — the batched dispersion solve
``pysurfinv_tpu_torch.surf_forward_batch`` — at the headline workload of
bench.py: the 86-layer Cascadia-ocean model padded to L=88, built
through the port's own model layer, 65,536 models (+-0.5% Vs/Vp jitter,
seed 0), 18 periods, Rayleigh and Love, then the MCMC sampler's warm
re-solve.  Phases, each of which raises on failure:

  1. card     the card's name and power limit (nvidia-smi) — no CPU
              fallback: without CUDA the script exits non-zero;
  2. build    the three secular-lane kernels, built with nvcc from csrc/;
  3. kernels  each kernel against its plain PyTorch version on the card,
              at main-path lane shapes (K=33 cold sweep, K=18 refinement
              and tangents, B=4096): |dF| <= 1e-4 * max_k |F| per model
              column, F_T/F_c to 2e-3 relative, b_hs and mm equal on
              >= 99.99% of lanes;
  4. slice    the solve for Rayleigh (bench config), Love (nbisect 6) and
              a warm Rayleigh re-solve with the sampler's settings
              (newton_sep=3, parallel/grid.py:271-280) seeded with the
              Rayleigh roots; every kernel's launch count must move in
              that run; ok >= 0.999 per wave, 0 < c < 5 km/s; on the
              first 1024 models the kernel path agrees with the plain
              path (ok on >= 99.9% of lanes, |dc| <= 1e-4 km/s); the
              TEST1 golden curve (tests/golden/test1.npz) to 1e-4;
  5. time     solves/s per wave and each kernel's time beside its plain
              version's, best of 3 windows after a warm-up (CUDA events
              for kernels, host clock around synchronised solves).

The warm re-solve is seeded with the batch's own Rayleigh roots
(``c_warm = c``).  With the sampler window (backoff 12 dc, coarse 8 dc)
its Newton iterations then start on the root itself, where sign(F) is
float32 noise; the kernels are bitwise equal to their plain versions, so
the comparison with the plain path still holds exactly.

Prints the card line and a JSON line of per-kernel results before the
last line, ``{"ok": true, "device": {...}}``.  Run from the repository
root: ``python3 chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
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
KERNEL_SOURCE = "pysurfinv_tpu_torch/csrc/secular_lanes.cu"
REPLACES = {
    "secular_lanes": "pysurfinv_tpu/ops/pallas_secular.py:843",
    "secular_lanes_frozen": "pysurfinv_tpu/ops/pallas_secular.py:1115",
    "secular_lanes_grad": "pysurfinv_tpu/ops/pallas_secular.py:779",
}


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
    from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _initial_c,
                                                    surf_forward_batch)
    from pysurfinv_tpu_torch.ops.flatten import flatten_factors

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
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log("[build]  " + line.strip())

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
    waves = {"rayleigh": cfg_r, "love": cfg_l}

    # ---- 3. kernels against their plain versions ---------------------
    kerr = {k: {"max_abs_err": 0.0} for k in REPLACES}
    shapes = {}
    for wave, cfg in waves.items():
        sub = [a[:B_LANES] for a in arrs]
        fac = flatten_factors(sub[0], nl[:B_LANES],
                              1 if wave == "love" else 2)
        model = [x.T.contiguous() for x in (*sub[1:], *fac)]
        nlb = nl[:B_LANES]
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
        k3 = sl.secular_lanes_grad(off, tk, mm, *model, nlb, wave=wave)
        p3 = sl.secular_lanes_grad(off, tk, mm, *model, nlb, wave=wave,
                                   backend="plain")
        e3 = compare_F(k3[0], p3[0], None, f"{wave} secular_lanes_grad")
        k3r = sl.secular_lanes_grad(root, tk, mm, *model, nlb, wave=wave)
        p3r = sl.secular_lanes_grad(root, tk, mm, *model, nlb, wave=wave,
                                    backend="plain")
        torch.cuda.synchronize()
        rk, rp = k3r[2] / k3r[1], p3r[2] / p3r[1]
        rerr = float(((rk - rp).abs()
                      / torch.clamp(rp.abs(), min=1e-6)).max())
        check(rerr <= 2e-3, f"{wave} secular_lanes_grad F_T/F_c relative "
              f"error {rerr:.3e} > 2e-3")
        log(f"[kernels] {wave}: secular_lanes max|dF| {e1:.3e} (b_hs/mm "
            f"agree {frac:.6f}); secular_lanes_frozen max|dF| {e2:.3e}; "
            f"secular_lanes_grad max|dF| {e3:.3e}, F_T/F_c max rel err "
            f"{rerr:.3e} ({card})")
        for name, e in (("secular_lanes", e1), ("secular_lanes_frozen", e2),
                        ("secular_lanes_grad", e3)):
            kerr[name]["max_abs_err"] = max(kerr[name]["max_abs_err"], e)
        kerr["secular_lanes_grad"]["ratio_rel_err_" + wave] = rerr
        kerr["secular_lanes"]["lanes_agree_" + wave] = frac
        shapes[wave] = (cs, ts, mm0, off, tk, mm, root)

    # ---- 4. the slice ------------------------------------------------
    sl.reset_launch_counts()
    out_r = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_r)
    out_l = surf_forward_batch(*arrs, periods, nl, wave="love", cfg=cfg_l)
    c_warm = out_r[0][:, :, 0]
    out_s = surf_forward_batch(*arrs, periods, nl, wave="rayleigh",
                               cfg=cfg_s, c_warm=c_warm)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in sl.KERNELS}
    log(f"[slice] kernel launches in the main-path run: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    runs = {"rayleigh": (out_r, arrs, cfg_r, None),
            "love": (out_l, arrs, cfg_l, None),
            "rayleigh_warm_sampler": (out_s, arrs, cfg_s, c_warm)}
    for name, (out, inp, cfg, cw) in runs.items():
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
            bad_u = uv[~good]
            log(f"[slice] {name}: u in (0, 5) km/s on {u_in:.6f} of ok "
                f"lanes ({int((~good).sum())} outside: "
                f"{bad_u[:6].tolist()})")
            check(u_in >= 0.999, f"{name} u in (0, 5) km/s on only "
                  f"{u_in:.6f} of ok lanes")
        # the same models through the plain versions on the card
        cp, up, okp = surf_forward_batch(
            *[a[:B_PLAIN] for a in inp], periods, nl[:B_PLAIN],
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

    # ---- 5. time -----------------------------------------------------
    for name, (_, inp, cfg, cw) in runs.items():
        wave = "love" if name == "love" else "rayleigh"

        def solve():
            return surf_forward_batch(*inp, periods, nl, wave=wave, cfg=cfg,
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
        log(f"[time] {name}: {best * 1e3:.2f} ms per {B_SLICE}-model "
            f"18-period solve, {B_SLICE / best:.1f} solves/s ({card})")

    kern_ms = {}
    for wave, cfg in waves.items():
        fac = flatten_factors(arrs[0], nl, 1 if wave == "love" else 2)
        model = [x.T.contiguous() for x in (*arrs[1:], *fac)]
        c_init = _initial_c(arrs[0], arrs[2], arrs[4], nl,
                            periods[0].expand(B_SLICE), wave, cfg)
        cs = (c_init[None] + cfg.coarse_first * DC
              * torch.arange(33, device=dev, dtype=torch.float32)[:, None])
        ts = periods[0].expand(cs.shape).contiguous()
        mm0 = torch.zeros(cs.shape, dtype=torch.int32, device=dev)
        root = torch.where(out_r[2] if wave == "rayleigh" else out_l[2],
                           (out_r if wave == "rayleigh" else out_l)[0],
                           3.5)[:, :, 0].T.contiguous()
        tk = periods[:, None].expand(root.shape).contiguous()
        _, _, mm = sl.secular_lanes(root + DC, tk, mm0[:18], *model, nl,
                                    wave=wave)
        calls = {
            "secular_lanes": lambda b: sl.secular_lanes(
                cs, ts, mm0, *model, nl, wave=wave, backend=b),
            "secular_lanes_frozen": lambda b: sl.secular_lanes_frozen(
                root, tk, mm, *model, nl, wave=wave, backend=b),
            "secular_lanes_grad": lambda b: sl.secular_lanes_grad(
                root, tk, mm, *model, nl, wave=wave, backend=b),
        }
        for name, fn in calls.items():
            ms = time_cuda(lambda: fn("kernel"), n=5)
            pms = time_cuda(lambda: fn("plain"), n=1)
            kern_ms[(name, wave)] = (ms, pms)
            K = 33 if name == "secular_lanes" else 18
            log(f"[time] {name} {wave} K={K} B={B_SLICE} L={L}: kernel "
                f"{ms:.3f} ms, plain {pms:.3f} ms ({card})")

    kernels = []
    for name, rep in REPLACES.items():
        ms, pms = kern_ms[(name, "rayleigh")]
        lms, lpms = kern_ms[(name, "love")]
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=rep,
            launches=launches[name], max_abs_err=kerr[name]["max_abs_err"],
            ms=ms, plain_ms=pms, love_ms=lms, love_plain_ms=lpms,
            shape=f"K={33 if name == 'secular_lanes' else 18},B={B_SLICE},"
                  f"L={L}",
            **{k: v for k, v in kerr[name].items() if k != "max_abs_err"}))

    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


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

#!/usr/bin/env python3
"""A/B of the PyTorch port's CUDA kernels on one NVIDIA GPU: the kernels
of this checkout against those built from another checkout's ``csrc/``,
measured in turns (base, this, this, base) in one process.

    git archive <commit> pysurfinv_tpu_torch/csrc | tar -x -C build/base
    python3 scripts/ab_kernels_torch.py build/base/pysurfinv_tpu_torch/csrc

Both libraries are built with the package's own nvcc flags and swapped
in under the package's wrappers, so every call runs the same PyTorch
code around a different kernel library.  On ``chip_smoke.py``'s bench
model (86 layers, L=88, +-0.5% jitter, seed 0) it prints, one line
each, with both designs' numbers:

  [build]   registers and spill bytes (ptxas) and the static SASS
            instructions of each kernel's longest loop (cuobjdump);
  [kscale]  secular_lanes at B=65,536 and B=8,192 (the model in L2) for
            K=1, 4 and 33, and secular_lanes_grad at K=18: ms and ps per
            applied lane-layer (mm - 1 layers a lane);
  [kernel]  the four kernels at the solve's shapes (B=65,536; K=33 sweep,
            K=18) and the sampler's (B=1,920; K=18, K=90 warm sweep);
  [bitwise] each kernel of both designs against its plain version at the
            sampler's shapes;
  [solve]   solves/s of chip_smoke's Rayleigh, Love and warm sampler runs;
  [sampler] invert_grid at the flagship workload (effective solves/s) and
            the secular kernels' device ms in a profiled 6-row run
            (``--no-sampler`` skips both).

The last line is a JSON object of every number.  Needs a GPU and nvcc.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("base", "this", "this", "base")


def log(*a):
    print(*a, flush=True)


def build_base(sl, csrc, out_dir):
    """Build ``csrc/secular_lanes.cu`` of another checkout with this
    package's flags; returns (library path, ptxas report)."""
    so = os.path.join(out_dir, "libsecular_lanes.so")
    res = subprocess.run([sl._nvcc(), *sl.NVCC_FLAGS, "-o", so,
                          os.path.join(csrc, "secular_lanes.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {csrc}:\n{res.stderr}")
    return so, res.stdout + res.stderr


def loop_sizes(sl, symbols, so):
    """Static SASS instructions of the longest loop of each kernel
    (Rayleigh and Love): the layer step of its recursion."""
    cuobjdump = os.path.join(os.path.dirname(sl._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        head = body.split("\n")[0]
        keys = [(name, wave) for name, sym in symbols.items()
                for flag, wave in (("ILb1", "rayleigh"), ("ILb0", "love"))
                if sym + flag in head]
        if not keys:
            continue
        ops = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        best = 0
        for a, op in ops:
            m = re.search(r"BRA (?:\S+ )?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) < a:
                start = int(m.group(1), 16)
                best = max(best, sum(1 for x, _ in ops if start <= x <= a))
        out[keys[0]] = best
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base_csrc", help="csrc/ directory of the base design")
    ap.add_argument("--no-sampler", action="store_true",
                    help="skip the flagship sampler runs")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels_torch: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pysurfinv_tpu_torch.convert import model_batch_from_numpy
    from pysurfinv_tpu_torch.ops import secular_lanes as sl
    from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _initial_c,
                                                    surf_forward_batch)
    from pysurfinv_tpu_torch.ops.flatten import flatten_factors

    card = cs.card_line()
    log(card)
    lib_this, info = sl.kernel_library()
    so_base, report_base = build_base(
        sl, os.path.abspath(args.base_csrc),
        tempfile.mkdtemp(prefix="ab_kernels_base_"))
    lib_base = ctypes.CDLL(so_base)
    for fn in ("secular_lanes_launch", "secular_lanes_frozen_launch",
               "secular_lanes_grad_launch", "refine_lanes_launch"):
        getattr(lib_base, fn).argtypes = getattr(lib_this, fn).argtypes
        getattr(lib_base, fn).restype = ctypes.c_int
    libs = {"base": lib_base, "this": lib_this}
    own = sl.kernel_library

    def use(v):
        sl.kernel_library = lambda: (libs[v], info)

    res = {"card": card, "build": {}, "kscale": {}, "kernel": {},
           "bitwise": {}, "solve": {}, "sampler": {}}
    for v, report, so in (("base", report_base, so_base),
                          ("this", info["log"], info["path"])):
        loops = loop_sizes(sl, cs.PTXAS_NAMES, so)
        res["build"][v] = {
            f"{k} {w}": dict(registers=r, spill_bytes=s,
                             loop_sass=loops.get((k, w)))
            for (k, w), (r, s) in sorted(cs.ptxas_usage(report).items())}
    for key in res["build"]["this"]:
        log(f"[build] {key}: " + "; ".join(
            f"{v} {res['build'][v].get(key)}" for v in ("base", "this")))

    dev = torch.device("cuda", 0)
    batch, nlay = cs.bench_batch(cs.B_SLICE, seed=0)
    L = batch.shape[2]
    *arrs, nl = model_batch_from_numpy(*batch.transpose(1, 0, 2), nlay,
                                       device=dev)
    periods = torch.tensor(cs.PERIODS, dtype=torch.float32, device=dev)
    cfg_r = SurfConfig(nmodes=1, nscan_first=512, nscan=12, nbisect=8,
                       warm_backoff=4, coarse_first=16)
    cfg_l = replace(cfg_r, nbisect=6)
    cfg_s = SurfConfig(nmodes=1, compute_group=False, nscan=32,
                       warm_backoff=12, nbisect=11, coarse=8, newton_sep=3,
                       coarse_first=8)
    cfgs = {"rayleigh": cfg_r, "love": cfg_l}
    use("this")
    out = {w: surf_forward_batch(*arrs, periods, nl, wave=w, cfg=c)
           for w, c in cfgs.items()}

    def zero(x):
        return torch.zeros(x.shape, dtype=torch.int32, device=dev)

    # name -> (call taking a backend, applied lane-layers or None)
    kscale, kernel = {}, {}
    for wave, cfg in cfgs.items():
        for B in (cs.B_SLICE, 8192, cs.B_SAMPLER):
            sub = [a[:B] for a in arrs]
            nlb = nl[:B].contiguous()
            fac = flatten_factors(sub[0], nlb, 1 if wave == "love" else 2)
            m = [x.T.contiguous() for x in (*sub[1:], *fac)]
            root = torch.where(out[wave][2], out[wave][0], 3.5)[:B, :, 0]
            root = root.T.contiguous()
            tk = periods[:, None].expand(root.shape).contiguous()
            _, _, mm = sl.secular_lanes(root + cs.DC, tk, zero(root), *m,
                                        nlb, wave=wave)

            def dyn(c, t, m=m, nlb=nlb, wave=wave):
                return lambda b: sl.secular_lanes(c, t, zero(c), *m, nlb,
                                                  wave=wave, backend=b)

            grad = (lambda b, root=root, tk=tk, mm=mm, m=m, nlb=nlb,
                    wave=wave: sl.secular_lanes_grad(
                        root, tk, mm, *m, nlb, wave=wave, backend=b))
            if B != cs.B_SAMPLER:
                c0 = _initial_c(sub[0], sub[2], sub[4], nlb,
                                periods[0].expand(B), wave, cfg)
                c33 = c0[None] + cfg.coarse_first * cs.DC * torch.arange(
                    33, device=dev, dtype=torch.float32)[:, None]
                for K in (1, 4, 33):
                    idx = (torch.linspace(0, 32, K).round().long() if K > 1
                           else torch.tensor([16]))
                    c = c33[idx.to(dev)].contiguous()
                    t = periods[0].expand(c.shape).contiguous()
                    _, _, mk = sl.secular_lanes(c, t, zero(c), *m, nlb,
                                                wave=wave)
                    kscale[f"secular_lanes {wave} B={B} K={K}"] = (
                        dyn(c, t), cs.layers_applied(mk, L))
                kscale[f"secular_lanes_grad {wave} B={B} K=18"] = (
                    grad, cs.layers_applied(mm, L))
            if B == 8192:
                continue
            lo, hi, mmb = cs.sweep_brackets(sl, root, tk, m, nlb, wave)
            if B == cs.B_SLICE:
                kernel[f"secular_lanes {wave} B={B} K=33"] = \
                    kscale[f"secular_lanes {wave} B={B} K=33"]
            else:
                c90, t90 = cs.warm_sweep(root, tk)
                kernel[f"secular_lanes {wave} B={B} K=18"] = (dyn(root, tk),
                                                              None)
                kernel[f"secular_lanes {wave} B={B} K=90"] = (dyn(c90, t90),
                                                              None)
            kernel[f"secular_lanes_frozen {wave} B={B} K=18"] = (
                lambda b, root=root, tk=tk, mm=mm, m=m, nlb=nlb, wave=wave:
                sl.secular_lanes_frozen(root, tk, mm, *m, nlb, wave=wave,
                                        backend=b), None)
            kernel[f"secular_lanes_grad {wave} B={B} K=18"] = (grad, None)
            kernel[f"refine_lanes {wave} B={B} K=18"] = (
                lambda b, lo=lo, hi=hi, tk=tk, mmb=mmb, m=m, nlb=nlb,
                wave=wave, n=cfg.nbisect: sl.refine_lanes(
                    lo, hi, tk, mmb, *m, nlb, wave=wave, n_ill=n,
                    n_newton=2, backend=b), None)

    for name, (fn, _) in kernel.items():
        if f"B={cs.B_SAMPLER} " not in name + " ":
            continue
        ref = fn("plain")
        for v in ("base", "this"):
            use(v)
            res["bitwise"].setdefault(name, {})[v] = cs.bitwise(
                fn("kernel"), ref)
        log(f"[bitwise] {name} against its plain version: "
            f"{res['bitwise'][name]}")

    for section, cases in (("kscale", kscale), ("kernel", kernel)):
        for v in ORDER:
            use(v)
            for name, (fn, _) in cases.items():
                n = 5 if f"B={cs.B_SLICE}" in name else 10
                res[section].setdefault(name, {}).setdefault(v, []).append(
                    cs.time_cuda(lambda: fn("kernel"), n=n))
        for name, (_, applied) in cases.items():
            t = res[section][name]
            extra = "" if not applied else "; ps per lane-layer " + "; ".join(
                f"{v} {min(t[v]) * 1e9 / applied:.2f}" for v in ("base",
                                                              "this"))
            log(f"[{section}] {name}: " + "; ".join(
                f"{v} " + " ".join(f"{x:.4f}" for x in t[v]) + " ms"
                for v in ("base", "this")) + extra)

    runs = {"rayleigh": (cfg_r, "rayleigh", None),
            "love": (cfg_l, "love", None),
            "rayleigh_warm_sampler": (cfg_s, "rayleigh",
                                      out["rayleigh"][0][:, :, 0])}
    for v in ORDER:
        use(v)
        for name, (cfg, wave, cw) in runs.items():
            def solve(cfg=cfg, wave=wave, cw=cw):
                return surf_forward_batch(*arrs, periods, nl, wave=wave,
                                          cfg=cfg, c_warm=cw)
            solve()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                solve()
                solve()
                torch.cuda.synchronize()
                best = min(best, (time.perf_counter() - t0) / 2)
            res["solve"].setdefault(name, {}).setdefault(v, []).append(
                cs.B_SLICE / best)
    for name, d in res["solve"].items():
        log(f"[solve] {name} solves/s: " + "; ".join(
            f"{v} " + " ".join(f"{x:.1f}" for x in d[v])
            for v in ("base", "this")))

    if not args.no_sampler:
        from torch.profiler import ProfilerActivity, profile

        from pysurfinv_tpu_torch.parallel import grid
        pts, lls = cs.mc_points(cs.MC_POINTS)
        tmp = tempfile.mkdtemp(prefix="ab_kernels_mc_")
        rows6 = dict(runN=6 * (cs.MC_RUN_N // cs.MC_CHAIN_L), chainL=6,
                     seed=cs.MC_SEED, segment=6, verbose=False)
        for v in ("base", "this"):   # first calls, untimed
            use(v)
            grid.invert_grid(pts, lls, outdir=f"{tmp}/warm_{v}", **rows6)
        for i, v in enumerate(ORDER):
            use(v)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid.invert_grid(pts, lls, outdir=f"{tmp}/{i}",
                             runN=cs.MC_RUN_N, chainL=cs.MC_CHAIN_L,
                             seed=cs.MC_SEED, segment=cs.MC_SEGMENT,
                             verbose=False)
            torch.cuda.synchronize()
            rate = cs.MC_POINTS * cs.MC_RUN_N / (time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                grid.invert_grid(pts, lls, outdir=f"{tmp}/p{i}", **rows6)
                torch.cuda.synchronize()
            k_ms = sum(getattr(e, "self_device_time_total", 0.0)
                       for e in prof.key_averages()
                       if "secular" in e.key or "refine" in e.key) / 1e3
            res["sampler"].setdefault(v, []).append(
                dict(solves_per_sec=rate, kernels_ms=k_ms))
            log(f"[sampler] {v}: {rate:.1f} effective solves/s; profiled "
                f"6-row run: the secular kernels {k_ms:.2f} ms")
    sl.kernel_library = own
    log(card)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

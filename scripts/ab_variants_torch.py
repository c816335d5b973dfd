#!/usr/bin/env python3
"""Time ``secular_lanes_frozen`` and ``refine_lanes`` of several kernel
libraries in turns in one process on one NVIDIA GPU: this checkout's
kernels against those built from other ``csrc/`` directories (earlier
commits, or copies of this one with a design change).

    git archive <commit> pysurfinv_tpu_torch/csrc | tar -x -C build/base
    python3 scripts/ab_variants_torch.py build/base/pysurfinv_tpu_torch/csrc \\
        build/variant/pysurfinv_tpu_torch/csrc

Each library is built with the package's nvcc flags (in parallel) and
swapped in under the package's wrappers, as ``ab_kernels_torch.py``
does.  On ``chip_smoke.py``'s bench model it prints each library's
registers and spills (ptxas) for the frozen, gradient and refine
kernels; whether each library's frozen and refine kernels (n_newton 0
and 2) are bitwise equal to their plain versions at the sampler's
shapes (B=1,920, K=18); and their times (CUDA events, best of 3
windows) at the solve's (B=65,536) and the sampler's shapes, Rayleigh
and Love, over two turns in the order this, variants, variants
reversed, this.  Needs a GPU and nvcc.
"""

import argparse
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMBOLS = {"frozen": "secular_frozen_kernel",
           "grad": "secular_grad_kernel",
           "illinois": "refine_illinois_kernel",
           "newton": "refine_newton_kernel",
           "one kernel": "refine_kernel"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("csrc", nargs="+", help="csrc/ directories to compare")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_variants_torch: needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import ab_kernels_torch as ab
    import chip_smoke as cs
    from pysurfinv_tpu_torch.convert import model_batch_from_numpy
    from pysurfinv_tpu_torch.ops import secular_lanes as sl
    from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig,
                                                    surf_forward_batch)
    from pysurfinv_tpu_torch.ops.flatten import flatten_factors

    card = cs.card_line()
    print(card, flush=True)
    lib_this, info = sl.kernel_library()
    libs, reports = {"this": lib_this}, {"this": info["log"]}

    def build(d):
        return d, ab.build_base(sl, os.path.abspath(d), tempfile.mkdtemp())

    with ThreadPoolExecutor(8) as ex:
        for d, (so, rep) in ex.map(build, args.csrc):
            libs[d] = ab.base_library(so, rep, lib_this)
            reports[d] = rep
    for v, rep in reports.items():
        print(f"[build] {v}: " + "; ".join(
            f"{k} {w} {r} registers, {s} B spill" for (k, w), (r, s)
            in sorted(cs.ptxas_usage(rep, SYMBOLS).items())), flush=True)

    def use(v):
        sl.kernel_library = lambda: (libs[v], info)

    dev = torch.device("cuda", 0)
    batch, nlay = cs.bench_batch(cs.B_SLICE, seed=0)
    *arrs, nl = model_batch_from_numpy(*batch.transpose(1, 0, 2), nlay,
                                       device=dev)
    periods = torch.tensor(cs.PERIODS, dtype=torch.float32, device=dev)
    cfg_r = SurfConfig(nmodes=1, nscan_first=512, nscan=12, nbisect=8,
                       warm_backoff=4, coarse_first=16)
    cfgs = {"rayleigh": cfg_r, "love": SurfConfig(
        nmodes=1, nscan_first=512, nscan=12, nbisect=6, warm_backoff=4,
        coarse_first=16)}
    use("this")
    cases = {}
    for wave, cfg in cfgs.items():
        out = surf_forward_batch(*arrs, periods, nl, wave=wave, cfg=cfg)
        for B in (cs.B_SLICE, cs.B_SAMPLER):
            sub = [a[:B] for a in arrs]
            nlb = nl[:B].contiguous()
            fac = flatten_factors(sub[0], nlb, 1 if wave == "love" else 2)
            m = [x.T.contiguous() for x in (*sub[1:], *fac)]
            root = torch.where(out[2], out[0], 3.5)[:B, :, 0].T.contiguous()
            tk = periods[:, None].expand(root.shape).contiguous()
            z = torch.zeros(root.shape, dtype=torch.int32, device=dev)
            _, _, mm = sl.secular_lanes(root + cs.DC, tk, z, *m, nlb,
                                        wave=wave)
            lo, hi, mmb = cs.sweep_brackets(sl, root, tk, m, nlb, wave)
            cases[f"frozen {wave} B={B}"] = (
                lambda b, root=root, tk=tk, mm=mm, m=m, nlb=nlb, wave=wave:
                sl.secular_lanes_frozen(root, tk, mm, *m, nlb, wave=wave,
                                        backend=b))
            for nn in (0, 2):
                cases[f"refine n_newton={nn} {wave} B={B}"] = (
                    lambda b, lo=lo, hi=hi, tk=tk, mmb=mmb, m=m, nlb=nlb,
                    wave=wave, nn=nn, n=cfg.nbisect: sl.refine_lanes(
                        lo, hi, tk, mmb, *m, nlb, wave=wave, n_ill=n,
                        n_newton=nn, compute_group=nn > 0, backend=b))

    for name, fn in cases.items():
        if f"B={cs.B_SAMPLER}" not in name:
            continue
        ref = fn("plain")
        same = {}
        for v in libs:
            use(v)
            same[v] = cs.bitwise(fn("kernel"), ref)
        print(f"[bitwise] {name} against its plain version: {same}",
              flush=True)

    order = list(libs) + list(reversed(list(libs)))
    res = {}
    for v in order:
        use(v)
        for name, fn in cases.items():
            n = 3 if "refine" in name and f"B={cs.B_SLICE}" in name else 10
            res.setdefault(name, {}).setdefault(v, []).append(
                cs.time_cuda(lambda: fn("kernel"), n=n))
    for name, d in res.items():
        print(f"[time] {name}: " + "; ".join(
            f"{v} " + " ".join(f"{x:.4f}" for x in d[v]) + " ms"
            for v in libs), flush=True)
    sl.kernel_library = lambda: (lib_this, info)
    print(card)


if __name__ == "__main__":
    main()

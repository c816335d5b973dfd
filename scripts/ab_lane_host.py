#!/usr/bin/env python3
"""Bit-for-bit A/B of the port's per-lane kernel code on the host: this
checkout's ``csrc/secular_lane.cuh`` against another checkout's, each
built with g++ through ``tests/secular_lane_host.cpp`` of its checkout.

    git archive <commit> pysurfinv_tpu_torch/csrc tests/secular_lane_host.cpp \\
        | tar -x -C build/base
    python3 scripts/ab_lane_host.py build/base

Runs every lane body both builds export (secular_lanes dynamic and
pinned, secular_lanes_frozen, secular_lanes_grad, refine_lanes over n_ill
0/3/8 x n_newton 0-3 x u on/off, and this checkout's refine phases with
their hand-over going through memory) on random lanes of jittered eus
models with a water layer on top, Rayleigh and Love, and prints for each
whether the outputs are bitwise equal.  Exits 1 if any is not.  Needs
g++, no GPU: the host libm is not PyTorch's, so neither build equals the
plain versions bit for bit, but the two builds equal each other.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(checkout, out_dir):
    so = os.path.join(out_dir, "libhost.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-I" + os.path.join(checkout, "pysurfinv_tpu_torch",
                                        "csrc"),
                    "-o", so, os.path.join(checkout, "tests",
                                           "secular_lane_host.cpp")],
                   check=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(so)
    lib.secular_lanes_host.argtypes = [P] * 15 + [I, I, I, I, F, F, I]
    lib.secular_lanes_frozen_host.argtypes = [P] * 11 + [I, I, I, I, F, I]
    lib.secular_lanes_grad_host.argtypes = [P] * 13 + [I, I, I, I, F, I]
    lib.refine_lanes_host.argtypes = [P] * 13 + [I, I, I, I, F, I, I, I, I]
    if hasattr(lib, "refine_illinois_host"):
        lib.refine_illinois_host.argtypes = [P] * 12 + [I, I, I, I, F, I, I]
        lib.refine_newton_host.argtypes = [P] * 12 + [I, I, I, I, F, I, I,
                                                      I]
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", help="root of the base checkout (its csrc/ "
                    "and tests/secular_lane_host.cpp)")
    ap.add_argument("--models", type=int, default=300)
    ap.add_argument("--rows", type=int, default=24)
    args = ap.parse_args()

    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_helpers import eus_batch, load_eus_model, with_water_top

    from pysurfinv_tpu_torch.ops import secular_lanes as tsl
    from pysurfinv_tpu_torch.ops.flatten import flatten_factors

    tmp = tempfile.mkdtemp(prefix="ab_lane_host_")
    libs = {}
    for v, checkout in (("base", os.path.abspath(args.base)), ("this", ROOT)):
        os.makedirs(os.path.join(tmp, v))
        libs[v] = build(checkout, os.path.join(tmp, v))

    h, vp, vs, rho, qsi, nlay = with_water_top(
        eus_batch(load_eus_model(), B=args.models, seed=3))
    rng = np.random.default_rng(11)
    K, B = args.rows, h.shape[0]
    p = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
    bits = lambda xs: [x.view(torch.int32) for x in xs]  # noqa: E731
    failed = 0

    def same(name, a, b):
        nonlocal failed
        ok = all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))
        failed += not ok
        print(f"{name}: bitwise {ok}", flush=True)

    for wave in ("rayleigh", "love"):
        fac = flatten_factors(torch.tensor(h), torch.tensor(nlay),
                              1 if wave == "love" else 2)
        model = [torch.tensor(x).T.contiguous() for x in (vp, vs, rho, qsi)]
        model += [x.T.contiguous() for x in fac]
        nl = torch.tensor(nlay)
        L, ray = model[0].shape[0], int(wave == "rayleigh")
        f32 = lambda x: torch.tensor(x.astype(np.float32))  # noqa: E731
        lo = f32(rng.uniform(2.6, 4.8, (K, B)))
        hi = (lo + f32(rng.uniform(0.003, 0.3, (K, B)))).contiguous()
        t = f32(rng.choice([8.0, 10.0, 20.0, 40.0, 80.0, 150.0], (K, B)))
        _, _, mm = tsl.secular_lanes_plain(
            hi, t, torch.zeros((K, B), dtype=torch.int32), *model, nl,
            wave=wave)
        mm = mm.contiguous()
        tag = f"{wave} K={K} B={B}"

        out = {}
        for v, lib in libs.items():
            r = {}
            for kind, mmf in (("dynamic", torch.zeros_like(mm)),
                              ("pinned", mm)):
                F, bh = torch.empty_like(lo), torch.empty_like(lo)
                m_out = torch.empty_like(mm)
                lib.secular_lanes_host(*p(lo, t, t, mmf, *model, nl, F, bh,
                                          m_out), K, B, L, ray, 4.0, 1.0, 1)
                r[kind] = (F, bh, m_out.view(torch.float32))
            F = torch.empty_like(lo)
            lib.secular_lanes_frozen_host(*p(lo, t, mm, *model, F), K, B, L,
                                          ray, 1.0, 1)
            r["frozen"] = (F,)
            G = [torch.empty_like(lo) for _ in range(3)]
            lib.secular_lanes_grad_host(*p(lo, t, mm, *model, *G), K, B, L,
                                        ray, 1.0, 1)
            r["grad"] = G
            out[v] = r
        for kind in out["base"]:
            same(f"{tag} secular_lanes {kind}" if kind in ("dynamic",
                                                          "pinned")
                 else f"{tag} secular_lanes_{kind}", out["base"][kind],
                 out["this"][kind])

        this = libs["this"]
        for n_ill in (0, 3, 8):
            for n_newton in (0, 1, 2, 3):
                for group in (1, 0):
                    res = {}
                    for v, lib in libs.items():
                        r, u = torch.empty_like(lo), torch.empty_like(lo)
                        lib.refine_lanes_host(*p(lo, hi, t, mm, *model, r, u),
                                              K, B, L, ray, 1.0, 1, n_ill,
                                              n_newton, group)
                        res[v] = (r, u)
                    name = (f"{tag} refine_lanes n_ill={n_ill} "
                            f"n_newton={n_newton} u={bool(group)}")
                    same(name, res["base"], res["this"])
                    if hasattr(this, "refine_illinois_host"):
                        st = torch.empty((K, B, 4))
                        r, u = torch.empty_like(lo), torch.empty_like(lo)
                        this.refine_illinois_host(
                            *p(lo, hi, t, mm, *model, st), K, B, L, ray, 1.0,
                            1, n_ill)
                        this.refine_newton_host(
                            *p(st, t, mm, *model, r, u), K, B, L, ray, 1.0, 1,
                            n_newton, group)
                        same(name + " (this: two phases through memory)",
                             res["base"], (r, u))
    print(f"{failed} comparisons differ")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()

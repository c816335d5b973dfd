#!/usr/bin/env python3
"""Posterior-parity harness of the PyTorch port: the batched sampler on
the card against the host ``MCinv`` oracle, or any two npz directories.

The port's counterpart of ``scripts/posterior_parity.py``.  By default it
runs the port's batched sampler (``Point.MCinvMP``, the CUDA kernels) and
the port's host-sequential oracle (``Point.MCinv`` with
``parity.fast_host_prior``, every forward the single-model float64
solve) on the 18-period Cascadia fixture point (the reference's own
example, point.py:400-410), then compares their posteriors with the
chain-replicate permutation test of
``pysurfinv_tpu_torch.inversion.parity``:

    # full validation (the host oracle takes hours; the card side
    # minutes):
    python3 scripts/posterior_parity_torch.py --out build/pp \\
        --runN 24000 --chainL 800 --seeds 0 1 2 3

    # compare two npz directories, e.g. the port's card run against a
    # run of the JAX package written on another machine:
    python3 scripts/posterior_parity_torch.py --host-dir JAX_RUN \\
        --device-dir PORT_RUN

Prints one JSON verdict line: the combined permutation p-value, the max
|z| and the worst statistic, the chain counts, both acceptance rates and
the eight largest z-scores.  p < 0.01 = the two posteriors are
statistically distinguishable at the run's power.  ``--device cpu`` runs
everything on the CPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the reference's example point (examples/invert_point.py:21-51)
SETTING = {
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
LOCAL = {"topo": -2.567706, "lithoAge": 0.6, "sedthk": 0.019,
         "mantleInitParmVs": [-0.3426920324186606, -0.1863907997418917,
                              -0.1882828662382096, -0.05648363217566826]}
PERIODS = [10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40, 50, 60,
           70, 80]
VELS = [3.5724066175576223, 3.6222019289297043, 3.6520621581430763,
        3.6588731735179367, 3.673255450218663, 3.683443600610537,
        3.6844591498161896, 3.689993791502759, 3.6935745493241487,
        3.696092260762209, 3.707185398688356, 3.7148258328900985,
        3.7209668755498257, 3.7486729577980427, 3.7706463827824748,
        3.82144353111797, 3.8603954933518914, 3.9030011211762767]
UNCERS = [0.006550350458769691, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005,
          0.005, 0.005, 0.005, 0.005, 0.005499996722895128,
          0.00751713560920708, 0.007910350806141024, 0.007711019920661203,
          0.010152973423528881, 0.01062776863809981, 0.015829560954127662]


def build_point():
    from pysurfinv_tpu_torch.inversion.point import PointCascadia
    return PointCascadia(SETTING, dict(LOCAL), periods=PERIODS, vels=VELS,
                         uncers=UNCERS)


def run_host(point, outdir, runN, chainL, seeds, device, slow_prior=False):
    from pysurfinv_tpu_torch.inversion.parity import fast_host_prior
    prior = None if slow_prior else fast_host_prior(point.initMod,
                                                    device=device)
    os.makedirs(outdir, exist_ok=True)
    for s in seeds:
        pid = f"host_seed{s}"
        if os.path.exists(os.path.join(outdir, pid + ".npz")):
            print(f"# {pid} exists, skipping", file=sys.stderr)
            continue
        t0 = time.time()
        point.MCinv(outdir=outdir, pid=pid, runN=runN, chainL=chainL,
                    seed=s, isgood=prior, device=device)
        print(f"# host seed {s}: {time.time() - t0:.0f}s", file=sys.stderr)


def run_device(point, outdir, runN, chainL, seeds, device):
    os.makedirs(outdir, exist_ok=True)
    for s in seeds:
        pid = f"device_seed{s}"
        if os.path.exists(os.path.join(outdir, pid + ".npz")):
            print(f"# {pid} exists, skipping", file=sys.stderr)
            continue
        t0 = time.time()
        point.MCinvMP(outdir=outdir, pid=pid, runN=runN, chainL=chainL,
                      seed=s, verbose=False, device=device)
        print(f"# device seed {s}: {time.time() - t0:.0f}s",
              file=sys.stderr)


def compare(host_dir, device_dir, point, zdeps, n_perm, device):
    import numpy as np

    from pysurfinv_tpu_torch.inversion.parity import (chain_statistics,
                                                      compare_posteriors,
                                                      glob_npz,
                                                      pooled_threshold)
    hf, df = glob_npz(host_dir), glob_npz(device_dir)
    if not hf or not df:
        sys.exit(f"missing npz files: host={len(hf)} device={len(df)}")
    thres = pooled_threshold([hf, df])
    kw = dict(zdeps=zdeps, thres=thres, vs_model=point.initMod,
              device=device)
    sh, _ = chain_statistics(hf, **kw)
    sd, _ = chain_statistics(df, **kw)
    res = compare_posteriors(sh, sd, n_perm=n_perm)
    ranked = sorted(res["z"].items(), key=lambda kv: -abs(kv[1]))
    out = {
        "p_value": res["p_value"], "max_abs_z": res["max_abs_z"],
        "worst": res["worst"], "n_host_chains": res["n_a"],
        "n_device_chains": res["n_b"], "threshold": thres,
        "host_acc": float(np.nanmean(sh["acceptance"])),
        "device_acc": float(np.nanmean(sd["acceptance"])),
        "top_z": {k: round(v, 2) for k, v in ranked[:8]},
    }
    print(json.dumps(out))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/posterior_parity_torch")
    ap.add_argument("--host-dir", help="npz dir of side A (default "
                    "<out>/host, the host oracle's)")
    ap.add_argument("--device-dir", help="npz dir of side B (default "
                    "<out>/device, the batched sampler's)")
    ap.add_argument("--runN", type=int, default=24000)
    ap.add_argument("--chainL", type=int, default=800)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--zdeps", type=float, nargs="+",
                    default=[5, 15, 30, 60, 100, 150])
    ap.add_argument("--n-perm", type=int, default=4000)
    ap.add_argument("--device", default="cuda",
                    help="device of the samplers and the Vs(z) rows")
    ap.add_argument("--compare-only", action="store_true")
    ap.add_argument("--slow-prior", action="store_true",
                    help="the host oracle uses the layers' own isgood")
    ap.add_argument("--skip-host", action="store_true")
    ap.add_argument("--skip-device", action="store_true")
    args = ap.parse_args()

    point = build_point()
    host_dir = args.host_dir or os.path.join(args.out, "host")
    device_dir = args.device_dir or os.path.join(args.out, "device")
    if not (args.compare_only or (args.host_dir and args.device_dir)):
        if not args.skip_device:
            run_device(point, device_dir, args.runN, args.chainL,
                       args.seeds, args.device)
        if not args.skip_host:
            run_host(point, host_dir, args.runN, args.chainL, args.seeds,
                     args.device, slow_prior=args.slow_prior)
    compare(host_dir, device_dir, point, args.zdeps, args.n_perm,
            args.device)


if __name__ == "__main__":
    main()

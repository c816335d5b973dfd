"""The plain reference against the port's plain path at tiny sizes on
the CPU, and the modules that the reference and the harness load."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT

from reference import cascadia as RC
from reference import chains as CH
from reference import secular as SE
from reference import threefry as TF


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


SURVEY = _config("cascadia_ocean_survey")
FORWARD = _config("cascadia_ocean_forward")
LOCALS = [{"topo": -2, "sedthk": 0.5, "lithoAge": 4.0},
          {"topo": -2.3, "sedthk": 0.13, "lithoAge": 1.2}]


@pytest.mark.parametrize("local", LOCALS)
def test_host_profile_is_the_object_apis(local):
    from pysurfinv_tpu_torch.models.model1d import buildModel1D, padded_profile
    mod = buildModel1D(FORWARD["setting"], local)
    h, vs, vp, rho, qs, _, _ = mod.seisPropLayers(refLayer=True)
    port = padded_profile(h, vs, vp, rho, qs)
    ref = RC.host_profile(RC.parse_point(FORWARD["setting"], local))
    assert ref[-1] == port[-1] == 86
    for a, b in zip(ref[:-1], port[:-1]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def _survey_points(n, seed=3):
    from pysurfinv_tpu_torch.inversion.point import PointCascadia
    rng = np.random.default_rng(seed)
    locs = []
    for _ in range(n):
        loc = dict(SURVEY["local"])
        loc["sedthk"] = float(rng.uniform(0.02, 0.92))
        loc["lithoAge"] = float(rng.uniform(0.5, 8.5))
        locs.append(loc)
    o = SURVEY["observations"]
    pts = [PointCascadia(SURVEY["setting"], loc, periods=o["periods"],
                         vels=o["vels"], uncers=o["uncers"]) for loc in locs]
    return pts, [RC.parse_point(SURVEY["setting"], loc) for loc in locs]


def test_lane_build_prior_and_spec_are_the_samplers():
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
    pts, ref = _survey_points(4)
    cm = CompiledModel(pts[0].initMod)
    for p, r in zip(pts, ref):
        s = cm.spec_of(p.initMod)
        for f in ("theta0", "vmin", "vmax", "step"):
            np.testing.assert_array_equal(getattr(s, f), r[f])
    st = RC.Structure(ref[0])
    assert st.L == cm.L
    N = 160
    lane_pt = [ref[i % 4] for i in range(N)]
    psi = torch.tensor(np.stack([cm.psi_of(pts[i % 4].initMod)
                                 for i in range(N)]))
    lo = torch.tensor(np.stack([r["vmin"] for r in lane_pt]))
    hi = torch.tensor(np.stack([r["vmax"] for r in lane_pt]))
    th0 = torch.tensor(np.stack([r["theta0"] for r in lane_pt]))
    u = torch.rand(N, 6, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    th = th0 + (lo + u * (hi - lo) - th0) * 0.3
    p = RC.lane_params(st, lane_pt, th)
    port = cm.build_profile_batch(th, psi)
    mine = RC.lane_profile(st, p)
    for a, b in zip(port[:5], mine[:5]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=0)
    assert torch.equal(port[5].long(), mine[5])
    good = cm.isgood(th, psi)
    assert 0 < int(good.sum()) < N
    assert torch.equal(good, RC.prior(st, p))


def test_random_streams_are_the_samplers():
    from pysurfinv_tpu_torch.inversion import random as R
    seed = 3 * 2 ** 31 + 5
    keys = R.fold_in(R.PRNGKey(seed), torch.arange(7))
    assert torch.equal(keys, TF.fold_in(TF.key(seed), torch.arange(7)))
    assert torch.equal(R.split(keys), TF.split(keys))
    for dt in (torch.float64, torch.float32):
        assert torch.equal(R.uniform(keys, (3,), dtype=dt),
                           TF.uniform(keys, 3, dt))
        assert torch.equal(R.uniform(keys, (), dtype=dt),
                           TF.unit(keys, 0, dt))
    lo = -torch.rand(7, 3, dtype=torch.float64)
    hi = torch.rand(7, 3, dtype=torch.float64) + 0.1
    assert torch.equal(R.truncated_normal(keys, lo, hi, (3,)),
                       TF.truncated_normal(keys, lo, hi, torch.float64))


def test_proposals_are_the_samplers():
    """The reference's replay of a row's proposal equals the sampler's
    retry loop on the same key and state."""
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
    from pysurfinv_tpu_torch.inversion.mcmc import ChainConfig, _propose
    from pysurfinv_tpu_torch.convert import spec_from_numpy
    from pysurfinv_tpu_torch.inversion import random as R
    pts, ref = _survey_points(3)
    cm = CompiledModel(pts[0].initMod)
    spec, psi = spec_from_numpy(
        tuple(np.stack([getattr(cm.spec_of(p.initMod), f) for p in pts])
              for f in ("theta0", "vmin", "vmax", "step")),
        np.stack([cm.psi_of(p.initMod) for p in pts]), device="cpu")
    keys = R.fold_in(R.PRNGKey(2 ** 33 + 1), torch.arange(3) * 11 + 4)
    o = SURVEY["observations"]
    obs = tuple(np.tile(o[k], (3, 1)) for k in ("periods", "vels", "uncers"))
    lanes = CH.Lanes(RC.Structure(ref[0]), ref,
                     obs + (np.ones((3, 18), bool),))
    for row in (1, 7):
        k = R.fold_in(keys, 2 * row)
        want, found = _propose(k, spec.theta0, spec, (psi,),
                               lambda t, c: cm.isgood(t, c[0]),
                               ChainConfig())
        got, f2 = CH.propose(lanes, k, spec.theta0, torch.arange(3))
        assert torch.equal(want, got) and torch.equal(found, f2)


def test_reference_solve_meets_the_converged_port_solve():
    """Phase roots and group velocities of the reference against the
    port's single-model float64 solve run to convergence (40 Illinois
    iterations; the default 12 stop ~1e-6 km/s short)."""
    from dataclasses import replace

    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward
    profs = [RC.host_profile(RC.parse_point(FORWARD["setting"], loc), L=88)
             for loc in LOCALS]
    per = torch.tensor(FORWARD["periods"][::3], dtype=torch.float64)
    X = [torch.tensor(np.stack([p[i] for p in profs])) for i in range(5)]
    nl = torch.tensor([p[5] for p in profs])
    c, u, ok = SE.solve(*X, nl, per, group=True)
    assert bool(ok.all())
    for i, p in enumerate(profs):
        cp, up, okp = surf_forward(*(torch.tensor(x) for x in p[:5]), per,
                                   p[5], cfg=replace(SurfConfig(),
                                                     nbisect=40))
        assert bool(okp.all())
        np.testing.assert_allclose(c[i].numpy(), cp[:, 0].numpy(), rtol=0,
                                   atol=1e-11)
        np.testing.assert_allclose(u[i].numpy(), up[:, 0].numpy(), rtol=0,
                                   atol=1e-6)


def test_misfit_is_the_points():
    from pysurfinv_tpu_torch.inversion.point import PointCascadia
    o = SURVEY["observations"]
    per = torch.tensor([o["periods"]] * 3, dtype=torch.float64)
    cobs = torch.tensor([o["vels"]] * 3, dtype=torch.float64)
    unc = torch.tensor([o["uncers"]] * 3, dtype=torch.float64)
    c = cobs + torch.tensor([[0.001], [0.05], [0.2]], dtype=torch.float64)
    c[2, 4] = 0.0
    m = torch.ones_like(c, dtype=torch.bool)
    want = PointCascadia._misfit_from_c(c, per, cobs, unc, m, valid=m)
    got = RC.misfit(c, cobs, unc, per, m)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert float(got[0][2]) == CH.MISFIT_FAIL


def _loaded(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_jax():
    mods = _loaded(
        "import sys, json; sys.path.insert(0, 'benchmarks');"
        "import reference.secular, reference.cascadia, reference.chains,"
        " reference.thermal, reference.threefry;"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & {"jax", "jaxlib", "flax", "pysurfinv_tpu",
                       "pysurfinv_tpu_torch"}


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a tiny size (the harness, the entry,
    the program, the judge) holds no module named jax, jaxlib, flax or
    pysurfinv_tpu, compared as whole top-level names."""
    code = (
        "import sys, json; sys.path[:0] = ['benchmarks/tests', 'benchmarks',"
        " '.'];"
        "import tempfile, conftest, run;"
        "from harness.cells import Cell;"
        "b = conftest.make_tiny(tempfile.mkdtemp());"
        "cell = Cell('forward.ocean.batch', bench_json=b[0], bench_dir=b[1]);"
        "run.run_cell(cell, 2**32 + 9, 0.1, False, 'cpu', run.process_start());"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    mods = _loaded(code)
    assert "pysurfinv_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "pysurfinv_tpu"}

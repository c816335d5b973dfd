"""Port parity of the model layer, and the port's import boundary.

* ``buildModel1D(...).seisPropLayers(refLayer=True)`` of the port against
  the JAX package's, float64, rtol 1e-10, for the bench setting
  (bench.py:36-50) and the Cascadia setting with Brownian parameters
  of the repository's verification notes; plus the padding for the
  solver and the model batch carried across from numpy.
* ``PureGird`` / ``PureGrid1D`` (a model re-wrapped from node profiles,
  as ``Model3D.smoothGrid`` builds them) against the JAX package's, and
  the lane mode of ``PureLayer`` / ``PureGrid`` against the JAX layers
  under ``jax.vmap``, float64, rtol 1e-12 (the port copies the profiles;
  nothing is computed but differences and midpoints).
* The lane-batched prior (``CompiledModel.isgood``) against the JAX
  package's compiled prior on a batch where every constraint rejects
  lanes and thin sediment layers drop on some.
* ``import pysurfinv_tpu_torch`` loads no JAX module.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pysurfinv_tpu.models import model1d as jm
from pysurfinv_tpu_torch.convert import model_batch_from_numpy
from pysurfinv_tpu_torch.models import model1d as tm

torch.set_num_threads(1)

LOCAL = {"topo": -2, "sedthk": 0.5, "lithoAge": 4.0}
BENCH = {
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
VERIFY = {
    "OceanWater": {"H": 2},
    "OceanSedimentCascadia": {"H": [1, "rel_pos", 100, 0.1]},
    "OceanCrust": {"H": 7, "Vs": [3.25, 3.94]},
    "OceanMantleHybrid": {
        "BottomDepth": 200, "Conversion": "Ritzwoller",
        "ThermAge": [4, "rel_pos", 200, 0.4],
        "Vs": [[0.2, "rel", 10, 0.02], [0.1, "rel", 10, 0.02],
               [-0.1, "rel", 10, 0.02], [-0.2, "rel", 5, 0.02]],
    },
    "Info": {"modelType": "CascadiaOcean", "period": 10,
             "refLayer": True, "lithoAgeQ": True},
}


@pytest.mark.parametrize("setting", [BENCH, VERIFY], ids=["bench", "verify"])
def test_seis_prop_layers_match_jax_f64(setting):
    ja = jm.buildModel1D(setting, dict(LOCAL))
    ta = tm.buildModel1D(setting, dict(LOCAL))
    assert type(ta).__name__ == type(ja).__name__
    j = ja.seisPropLayers(refLayer=True)
    t = ta.seisPropLayers(refLayer=True)
    assert len(t[0]) == len(j[0]) > 80
    for a, b in zip(t[:6], j[:6]):
        assert np.asarray(a).dtype == np.float64
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)
    assert t[6] == j[6]
    assert ta.toYML() == ja.toYML()

    pj = jm.padded_profile(*j[:5])
    pt = tm.padded_profile(*t[:5])
    assert pt[-1] == pj[-1]
    for a, b in zip(pt[:-1], pj[:-1]):
        np.testing.assert_allclose(a, b, rtol=1e-10)


def test_model_batch_from_numpy():
    rng = np.random.default_rng(0)
    arrs = [rng.random((3, 8)) for _ in range(5)]
    out = model_batch_from_numpy(*arrs, 6, device="cpu")
    assert all(x.dtype == torch.float32 and x.shape == (3, 8)
               for x in out[:5])
    assert out[5].dtype == torch.int32 and out[5].tolist() == [6, 6, 6]
    np.testing.assert_array_equal(out[2].numpy(), arrs[2].astype(np.float32))
    with pytest.raises(ValueError):
        model_batch_from_numpy(*arrs, 9, device="cpu")


PORT_MODULES = ("pysurfinv_tpu_torch", "pysurfinv_tpu_torch.convert",
                "pysurfinv_tpu_torch.compat",
                "pysurfinv_tpu_torch.utils",
                "pysurfinv_tpu_torch.profiling",
                "pysurfinv_tpu_torch.models.model1d",
                "pysurfinv_tpu_torch.models.layers",
                "pysurfinv_tpu_torch.models.thermal",
                "pysurfinv_tpu_torch.inversion.random",
                "pysurfinv_tpu_torch.inversion.priors",
                "pysurfinv_tpu_torch.inversion.compiled",
                "pysurfinv_tpu_torch.inversion.mcmc",
                "pysurfinv_tpu_torch.inversion.adaptive",
                "pysurfinv_tpu_torch.inversion.mala",
                "pysurfinv_tpu_torch.inversion.point",
                "pysurfinv_tpu_torch.inversion.parity",
                "pysurfinv_tpu_torch.parallel.grid",
                "pysurfinv_tpu_torch.parallel.mesh",
                "pysurfinv_tpu_torch.geo.grid",
                "pysurfinv_tpu_torch.geo.model3d",
                "pysurfinv_tpu_torch.geo.exchange",
                "pysurfinv_tpu_torch.geo.decorations",
                "pysurfinv_tpu_torch.ops.kernels",
                "pysurfinv_tpu_torch.ops.eigen",
                "pysurfinv_tpu_torch.ops.secular_assoc",
                "pysurfinv_tpu_torch.senskernel",
                "pysurfinv_tpu_torch.data.prem")


def test_port_imports_no_jax():
    """The port's modules, their lazy exports (PostPoint, fast_surf, the
    analysis surface, the experimental samplers) and chip_smoke.py, which
    runs where JAX is absent, import neither JAX nor the JAX package."""
    code = ("import sys, runpy, " + ", ".join(PORT_MODULES) + "; "
            "from pysurfinv_tpu_torch import PostPoint, fast_surf; "
            "from pysurfinv_tpu_torch import Model3D, PureGird, "
            "points_devices; "
            "from pysurfinv_tpu_torch import SensKernel, sensitivity_kernels, "
            "eigenfunctions_regular; "
            "from pysurfinv_tpu_torch import Model1D_Exchange, "
            "Model3D_Exchange, mala_point, adaptive_point, tuned_rwm_point, "
            "AdaptConfig; "
            "from pysurfinv_tpu_torch.inversion.point import "
            "PostPointCascadia; "
            "runpy.run_path('chip_smoke.py', run_name='chip_smoke'); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'pysurfinv_tpu.')) "
            "or m == 'pysurfinv_tpu'); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert res.returncode == 0, res.stdout + res.stderr


def _node_profiles(seed=0):
    """(z, vs, vp, rho, qs, qp, groups) node profiles of the Cascadia
    setting with a seeded Vs jitter — the shape of what
    ``Model3D.smoothGrid`` hands ``PureGird``."""
    z, vs, vp, rho, qs, qp, grp = tm.buildModel1D(VERIFY, dict(LOCAL)) \
        .seisPropGrids()
    rng = np.random.default_rng(seed)
    vs = vs * (1.0 + 0.01 * rng.standard_normal(vs.shape))
    return [z, vs, vp, rho, qs, qp, list(grp)]


def test_pure_gird_matches_jax():
    prof = _node_profiles()
    info = {"topo": -2.0, "refLayer": False}
    assert tm.PureGrid1D is tm.PureGird
    got = tm.PureGird(prof, info=dict(info))
    ref = jm.PureGird(prof, info=dict(info))
    assert [l.prop["Group"] for l in got.layers] == \
        [l.prop["Group"] for l in ref.layers] == list(dict.fromkeys(prof[6]))
    for refLayer in (False, True):
        a, b = got.seisPropGrids(refLayer=refLayer), \
            ref.seisPropGrids(refLayer=refLayer)
        assert a[-1] == b[-1]
        for x, y in zip(a[:-1], b[:-1]):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
        a, b = got.seisPropLayers(refLayer=refLayer), \
            ref.seisPropLayers(refLayer=refLayer)
        assert list(a[-1]) == list(b[-1])
        for x, y in zip(a[:-1], b[:-1]):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.value([3.0, 50.0, 150.0]),
                               ref.value([3.0, 50.0, 150.0]), rtol=1e-12)
    assert got.moho() == ref.moho()
    with pytest.raises(AttributeError):
        got.loadYML({})


def test_pure_layers_lane_mode_match_jax_vmap():
    """Lane mode: profiles given as (N, n) lane tensors or shared (n,)
    constants come back as (N, n) rows, equal to the JAX layers traced
    under ``jax.vmap``."""
    import jax
    import jax.numpy as jnp

    from pysurfinv_tpu.models import layers as jl
    from pysurfinv_tpu_torch.models import layers as tl

    rng = np.random.default_rng(2)
    N, n = 5, 7
    z = np.cumsum(rng.uniform(0.5, 2.0, n))
    vs = 3.0 + rng.random((N, n))   # per lane
    shared = {k: 1.0 + rng.random(n) for k in ("vp", "rho", "qs", "qp")}
    ref = torch.zeros(N, dtype=torch.float64)

    def grid_parm(vs_row):
        return dict(z=z, vs=vs_row, **shared)

    g_t = tl.PureGrid(grid_parm(torch.tensor(vs))).seisPropGrids(lanes=ref)
    g_j = jax.vmap(lambda v: jl.PureGrid(grid_parm(v)).seisPropGrids())(
        jnp.asarray(vs))
    H_t = tl.PureGrid(dict(grid_parm(vs[0]), z=torch.tensor(
        z[None] * (1 + np.arange(N))[:, None]))).H(lanes=ref)
    H_j = jax.vmap(lambda s: jl.PureGrid(dict(grid_parm(vs[0]),
                                              z=z * s)).H())(
        jnp.arange(1.0, N + 1))
    h = np.diff(z)
    lay_t = tl.PureLayer(dict(h=torch.tensor(h[None] * (1 + np.arange(N))[
        :, None]), vs=vs[0, 1:], **{k: v[1:] for k, v in shared.items()}))
    lay_j = lambda s: jl.PureLayer(dict(  # noqa: E731
        h=h * s, vs=vs[0, 1:], **{k: v[1:] for k, v in shared.items()}))
    L_t = lay_t.seisPropLayers(lanes=ref)
    L_j = jax.vmap(lambda s: lay_j(s).seisPropLayers())(jnp.arange(1.0,
                                                                   N + 1))
    HL_t = lay_t.H(lanes=ref)
    HL_j = jax.vmap(lambda s: lay_j(s).H())(jnp.arange(1.0, N + 1))
    for a, b in [*zip(g_t, g_j), (H_t, H_j), *zip(L_t, L_j), (HL_t, HL_j)]:
        assert a.shape == b.shape and a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=0)
    # host mode is unchanged: (n,) profiles
    assert tl.PureGrid(grid_parm(vs[0])).seisPropGrids()[1].shape == (n,)


def test_cpu_prior_is_the_jax_packages():
    """The Cascadia test batch of ``test_torch_prior_graph.py``, thin-layer
    lanes included, against the JAX package's compiled prior."""
    import jax
    import jax.numpy as jnp
    from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS
    from test_torch_prior_graph import _batch, _models

    from pysurfinv_tpu.inversion.compiled import CompiledModel
    from pysurfinv_tpu.inversion.point import PointCascadia

    cm, mods = _models("cascadia")
    jcm = CompiledModel(PointCascadia(SETTING, LOCAL, periods=PERIODS,
                                      vels=VELS, uncers=UNCERS).initMod)
    th, ps = _batch(cm, mods, 512, seed=2)
    want = np.asarray(jax.jit(jax.vmap(jcm.isgood))(
        jnp.asarray(th.numpy()), jnp.asarray(ps.numpy())))
    got = cm.isgood(th, ps).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def test_profiling_helpers(tmp_path):
    """``trace`` / ``annotate`` (a torch.profiler trace written as Chrome
    JSON) and the counters (``count``, ``counting``, ``counters``,
    ``reset_counters``) on a CPU computation: a span and a count land
    only while tracing is on."""
    from pysurfinv_tpu_torch import profiling

    x = torch.ones(64, 64, dtype=torch.float64)
    profiling.reset_counters()
    with profiling.annotate("off"):
        profiling.count("rows", 64)
    assert "rows" not in profiling.counters()
    with profiling.trace(str(tmp_path / "tr")) as prof:
        assert profiling.enabled()
        with profiling.annotate("matmul"):
            (x @ x).sum()
        profiling.count("rows", 64)
    assert (tmp_path / "tr" / "trace.json").exists()
    keys = {e.key for e in prof.key_averages()}
    assert "matmul" in keys and "off" not in keys
    with profiling.counting():
        profiling.count("rows", 0.5)
        # the counters alone: a span stays the shared no-op context
        assert profiling.annotate("x") is profiling.annotate("y")
        assert not isinstance(profiling.annotate("x"),
                              torch.profiler.record_function)
    with profiling.counting(False):
        profiling.count("rows", 1)
    got = profiling.counters()
    assert got["rows"] == 64.5 and not profiling.enabled()
    assert {"kernel.secular_lanes", "kernel.refine_lanes"} <= set(got)
    profiling.reset_counters()
    assert "rows" not in profiling.counters()
    assert not hasattr(profiling, "throughput")

"""The prior as CUDA graphs (``CompiledModel.isgood``).

On CUDA each batch shape of the prior is captured once into a CUDA graph
and replayed after; CPU tensors run the ops one by one.

* CPU: the test batches make every constraint of the prior reject some
  lanes (thin layers dropped on some; ``tests/test_torch_models.py``
  holds the prior to the JAX package's on them); a CPU call runs the
  plain ops (one
  ``prior.plain_calls`` a call, no capture, no host read counted); the
  prior reads no device value on the host and, once its tables are
  built, copies nothing from the host (run on the meta device); the
  cached tables are reused and follow the device and dtype.
* ``cuda``-marked (skip without a card): the replayed prior is bit for
  bit the plain ops at the survey's 1,920 and 2,040 rows, at 1 and at a
  ragged 1,001 rows, in float64 and float32, with ``psis`` given and
  omitted, on both test models; new inputs between two replays give new
  masks; the returned mask is no graph memory; a shape whose capture
  fails runs the plain ops; 20 priori steps of 480 lanes give the same
  rows and counters with the graph as with the plain ops.

The file imports no JAX; on a GPU machine it runs alone: ``python -m
pytest --noconftest -p no:cacheprovider tests/test_torch_prior_graph.py``.
"""

import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu_torch import profiling
from pysurfinv_tpu_torch.inversion import priors as P
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel

torch.set_num_threads(1)

# the Cascadia example point at four (sediment thickness, plate age)
POINTS = ((0.019, 0.6), (0.5, 3.0), (0.9, 8.0), (0.2, 1.5))
# a model of the general type with two sediment layers, whose velocities
# can fall from one to the next, and a spline mantle
GENERAL = {
    "OceanSediment": {"H": 0.5, "Vs": [1.0, "abs", 0.9, 0.05]},
    "Sediment": {"H": 0.5, "Vs": [[1.0, "abs", 0.9, 0.05],
                                  [1.2, "abs", 0.9, 0.05]]},
    "OceanCrust": {"H": 7, "Vs": [[3.25, "abs", 0.6, 0.05],
                                  [3.94, "abs", 0.6, 0.05]]},
    "OceanMantle": {"H": 100, "Vs": [[4.4, "abs", 0.3, 0.02],
                                     [4.3, "abs", 0.3, 0.02],
                                     [4.5, "abs", 0.3, 0.02]]},
    "Info": {"modelType": "General"},
}
SHAPES = [1, 1001, 1920, 2040]


def _models(name):
    """(compiled model, the models its lanes cycle through)."""
    if name == "cascadia":
        from pysurfinv_tpu_torch.inversion.point import PointCascadia
        mods = [PointCascadia(SETTING, dict(LOCAL, sedthk=s, lithoAge=a),
                              periods=PERIODS, vels=VELS,
                              uncers=UNCERS).initMod for s, a in POINTS]
    else:
        from pysurfinv_tpu_torch.models.model1d import buildModel1D
        mods = [buildModel1D(GENERAL, {})]
    return CompiledModel(mods[0]), mods


@pytest.fixture(scope="module", params=["cascadia", "general"])
def models(request):
    return _models(request.param)


def _fresh(cm):
    """A compiled model of ``cm``'s structure with no table or graph
    yet."""
    return CompiledModel(cm.model)


def _batch(cm, mods, n, seed, dtype=torch.float64):
    """(thetas, psis) of ``n`` lanes: thetas uniform over each bound's
    range widened by a quarter at both ends (the Cascadia sediment then
    falls below 0.01 km on some lanes, which drops it), the crust's fixed
    velocities scaled by 0.9-1.1 lane by lane."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=g, dtype=torch.float64)  # noqa
    idx = np.arange(n) % len(mods)
    specs = [cm.spec_of(m) for m in mods]
    vmin = torch.as_tensor(np.stack([specs[i].vmin for i in idx]))
    vmax = torch.as_tensor(np.stack([specs[i].vmax for i in idx]))
    w = vmax - vmin
    th = vmin - 0.25 * w + 1.5 * w * u(vmin.shape)
    psi = torch.as_tensor(np.stack([cm.psi_of(mods[i]) for i in idx]))
    for j, (li, k, _, v) in enumerate(cm._const_slots):
        if cm._layers[li].prop["Group"] == "crust" and k == "Vs":
            psi[:, j] = v * (0.9 + 0.2 * u(n))
    return th.to(dtype), psi.to(dtype)


def _constraints(cm, th, ps):
    """Each constraint of the prior on its own, (N,) bool each: the
    checks of ``CompiledModel._isgood_plain`` one by one."""
    n = cm._n_nodes_main
    z, vs, *_ = cm.build_grids(th, ps, vs_only=True)
    z, vs = z[:, :n], vs[:, :n]
    sed, crust, mantle, grp, starts, ends, of_node = \
        cm._prior_tables(z.device)
    keep = ((z[:, ends] - z[:, starts]) > 0.01)[:, of_node]
    out = {
        "sediment_vs": torch.where(sed & keep, vs >= 0.2, True).all(dim=1),
        "group_jumps": P.group_jumps_positive(vs, grp, keep),
        "sediment_mono": P.mono_increase(vs, sed & keep, eps=-1e-12),
        "crust_mono": P.mono_increase(vs, crust & keep, eps=-1e-12),
        "bottom_gradient": ((vs[:, -1] - vs[:, -2])
                            / torch.clamp(z[:, -1] - z[:, -2], min=1e-9)) > 0,
    }
    if "Ocean" in type(cm.model).__name__:
        meanM = torch.where(mantle, vs, 0.0).sum(dim=1) / cm._n_mantle
        i0 = int(np.argmax(cm.grp_nodes[:n] == "mantle"))
        zM, vM = z[:, i0:n], vs[:, i0:n]
        slope = (torch.diff(vM, dim=1)
                 / torch.clamp(torch.diff(zM, dim=1), min=1e-9))
        out.update(
            extrema=P.local_extrema_oscillation_lanes(vs, mantle,
                                                      0.1 * meanM),
            no_local_max=P.no_local_max(vs, mantle),
            slope=slope.min(dim=1).values >= slope[:, 0] * 1.5,
            cwt=P.cwt_oscillation_lanes(
                vM, zM, torch.ones(vM.shape[1], dtype=torch.bool,
                                   device=z.device), limit=0.3))
    return out


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_every_constraint_rejects_some_lanes():
    """Over the two test models' batches each constraint rejects lanes,
    and the prior is their conjunction."""
    rejected = {}
    for name in ("cascadia", "general"):
        cm, mods = _models(name)
        th, ps = _batch(cm, mods, 2040, seed=1)
        each = _constraints(cm, th, ps)
        for k, v in each.items():
            rejected[k] = rejected.get(k, 0) + int((~v).sum())
        assert torch.equal(torch.stack(list(each.values())).all(0),
                           cm.isgood(th, ps))
        if name == "cascadia":
            z, *_ = cm.build_grids(th, ps, vs_only=True)
            _, _, _, _, starts, ends, _ = cm._prior_tables(z.device)
            thin = ((z[:, ends] - z[:, starts]) <= 0.01).any(dim=1)
            assert 0 < int(thin.sum()) < len(thin)
    assert len(rejected) == 9 and all(rejected.values()), rejected


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_calls_run_the_plain_ops(models, dtype):
    cm, mods = models
    th, ps = _batch(cm, mods, 64, seed=3, dtype=dtype)
    profiling.reset_counters()
    with profiling.counting():
        ok = [cm.isgood(th, ps), cm.isgood(th), cm.isgood(th[:7], ps[:7])]
    got = profiling.counters()
    profiling.reset_counters()
    assert got.get("prior.plain_calls") == 3
    for name in ("prior.graph_replays", "prior.graph_captures",
                 "host_syncs"):
        assert name not in got, name
    assert not cm._graphs
    assert torch.equal(ok[0], cm._isgood_plain(th, ps))
    assert torch.equal(ok[1], cm._isgood_plain(th))
    assert torch.equal(ok[2], ok[0][:7])


def test_prior_reads_nothing_back_and_copies_nothing_once_built(models):
    """On the meta device a host read of a device value raises, and a
    dispatch spy sees every copy from a host array to the device: after
    the first call has built the tables, a call makes none."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Spy(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.copies = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            devs = {a.device.type for a in tree_leaves((args, kwargs))
                    if isinstance(a, torch.Tensor)}
            to = kwargs.get("device")
            if "cpu" in devs and (len(devs) > 1 or to is not None and
                                  torch.device(to).type != "cpu"):
                self.copies.append(func.__name__)
            return func(*args, **kwargs)

    cm, mods = models
    th, ps = (x.to("meta") for x in _batch(cm, mods, 5, seed=4))
    first = Spy()
    with first:
        cm.isgood(th, ps)
        cm.isgood(th)
    assert first.copies        # the tables, built at the first call
    spy = Spy()
    with spy:
        ok = cm.isgood(th, ps)
        cm.isgood(th)
    assert spy.copies == [] and ok.device.type == "meta"


def test_cached_tables_follow_the_device_and_dtype(models):
    from pysurfinv_tpu_torch.models import layers, thermal

    cm, mods = models
    cm = _fresh(cm)
    th, ps = _batch(cm, mods, 8, seed=5)
    cm.isgood(th, ps)
    cm.isgood(th)
    tables = dict(cm._consts)
    cm.isgood(th, ps)
    cm.isgood(th)
    assert cm._consts.keys() == tables.keys()
    assert all(cm._consts[k] is v for k, v in tables.items())
    assert all(k[2] == torch.device("cpu") for k in tables)
    cm.isgood(th.float(), ps.float())
    assert cm._consts.keys() == tables.keys()   # masks and indices: any dtype
    cm.isgood(th.float())
    assert cm._consts[("psi0", torch.float32,
                       torch.device("cpu"))].dtype == torch.float32
    for ref in (th[:, 0], th[:, 0].float(), th[:, 0].to("meta")):
        a, b = layers._lin01(7, ref), layers._lin01(7, ref)
        assert a.data_ptr() == b.data_ptr() or ref.device.type == "meta"
        assert (a.dtype, a.device) == (ref.dtype, ref.device)
        basis = layers._basis_lanes(9, 4, None, ref)
        assert basis is layers._basis_lanes(9, 4, None, ref)
        assert (basis.dtype, basis.device) == (ref.dtype, ref.device)
    T = torch.full((3,), 1500.0, dtype=torch.float32)
    v = thermal.ritzwoller_vs(T, T * 0 + 2.0)
    assert v.dtype == torch.float32
    np.testing.assert_array_equal(
        v.numpy(), thermal.ritzwoller_vs(T, T * 0 + 2.0,
                                         ws=list(thermal._RITZ_WS)).numpy())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("given", [True, False], ids=["psis", "no_psis"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", SHAPES)
def test_replay_is_the_plain_ops(models, cuda_device, n, dtype, given):
    cm, mods = models
    cm = _fresh(cm)
    th, ps = (x.to(cuda_device) for x in _batch(cm, mods, n, seed=6,
                                                 dtype=dtype))
    ps = ps if given else None
    profiling.reset_counters()
    with profiling.counting():
        first, again = cm.isgood(th, ps), cm.isgood(th, ps)
    got = profiling.counters()
    profiling.reset_counters()
    plain = cm._isgood_plain(th, ps)
    assert torch.equal(first, plain) and torch.equal(again, plain)
    assert got.get("prior.graph_captures") == 1
    assert got.get("prior.graph_replays") == 2
    assert "prior.plain_calls" not in got and "host_syncs" not in got


@pytest.mark.cuda
def test_new_inputs_between_replays(models, cuda_device):
    cm, mods = models
    cm = _fresh(cm)
    a, pa = (x.to(cuda_device) for x in _batch(cm, mods, 1920, seed=7))
    b, pb = (x.to(cuda_device) for x in _batch(cm, mods, 1920, seed=8))
    ok_a = cm.isgood(a, pa)
    ok_b = cm.isgood(b, pb)
    ok_a2 = cm.isgood(a, pa)
    want_a, want_b = cm._isgood_plain(a, pa), cm._isgood_plain(b, pb)
    assert not torch.equal(want_a, want_b)
    assert torch.equal(ok_a, want_a) and torch.equal(ok_a2, want_a)
    assert torch.equal(ok_b, want_b)
    assert len(cm._graphs) == 1


@pytest.mark.cuda
def test_mask_is_no_graph_memory(models, cuda_device):
    cm, mods = models
    cm = _fresh(cm)
    a, pa = (x.to(cuda_device) for x in _batch(cm, mods, 2040, seed=9))
    b, pb = (x.to(cuda_device) for x in _batch(cm, mods, 2040, seed=10))
    ok_a = cm.isgood(a, pa)
    (_, _, _, static), = cm._graphs.values()
    assert ok_a.data_ptr() != static.data_ptr()
    kept = ok_a.clone()
    ok_b = cm.isgood(b, pb)
    assert ok_b.data_ptr() not in (static.data_ptr(), ok_a.data_ptr())
    assert torch.equal(ok_a, kept)
    ok_a.logical_not_()                 # a caller's write stays its own
    assert torch.equal(cm.isgood(b, pb), ok_b)


@pytest.mark.cuda
def test_a_failed_capture_runs_the_plain_ops(cuda_device, monkeypatch):
    """A lane mode that reads the device cannot be captured: that shape
    runs the plain ops, counted as plain calls; other models' shapes
    still capture, and the stream is the caller's again."""
    cm, mods = _models("cascadia")
    th, ps = (x.to(cuda_device) for x in _batch(cm, mods, 300, seed=11))
    plain = cm._isgood_plain

    def reads_the_device(thetas, psis=None):
        bool(thetas.isfinite().all())
        return plain(thetas, psis)

    monkeypatch.setattr(cm, "_isgood_plain", reads_the_device)
    stream = torch.cuda.current_stream()
    profiling.reset_counters()
    with profiling.counting():
        ok = [cm.isgood(th, ps), cm.isgood(th, ps)]
    got = profiling.counters()
    assert torch.cuda.current_stream() == stream
    assert got.get("prior.plain_calls") == 2
    assert "prior.graph_captures" not in got
    assert "prior.graph_replays" not in got
    want = plain(th, ps)
    assert all(torch.equal(x, want) for x in ok)
    other = _fresh(cm)
    profiling.reset_counters()
    with profiling.counting():
        assert torch.equal(other.isgood(th, ps), want)
    assert profiling.counters().get("prior.graph_captures") == 1
    profiling.reset_counters()


@pytest.mark.cuda
def test_twenty_priori_steps_graph_equals_plain(cuda_device, monkeypatch):
    """20 priori steps of 480 lanes of the survey's sampler: the same rows
    bit for bit, the same candidates judged and host reads, with the
    prior replayed from graphs and run as plain ops."""
    from test_torch_draws import _segments, _survey_lanes

    cm, lanes = _survey_lanes(cuda_device)
    rows_g, got_g, _ = _segments(cm, lanes)
    plain = _fresh(cm)
    monkeypatch.setattr(plain, "_isgood_graph", lambda *a: None)
    rows_p, got_p, _ = _segments(plain, lanes)
    assert torch.equal(rows_g, rows_p)
    for name in ("propose.candidates", "host_syncs"):
        assert got_g[name] == got_p[name] > 0, name
    assert got_g["prior.graph_replays"] == got_p["prior.plain_calls"] > 0
    assert "prior.plain_calls" not in got_g
    assert "prior.graph_captures" not in got_g   # the first segment's
    assert "prior.graph_replays" not in got_p

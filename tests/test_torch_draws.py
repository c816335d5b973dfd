"""The sampler's draw kernels (``ops/draw_lanes.py``): dispatch, their
CUDA arithmetic on the host, and (on a machine with an NVIDIA GPU) the
kernels themselves.

* CPU keys take the plain torch ops of ``inversion/random.py`` and
  ``mcmc._draw``; nothing builds or launches a kernel for them, and
  ``backend="kernel"`` raises there.
* The kernels' per-lane code (``csrc/draw_lane.cuh``) compiled with g++
  gives the plain version's bits: ``fold_in``, ``split``, ``random_bits``
  of 32 and 64 bits, a retry round's W-long key walk, and its float64
  candidates (perturbations, resets, and rounds that straddle
  ``n_perturb_rounds``), over 1, 7, 1,920 and 2,049 lanes and W of 1, 2,
  34 and 64.
* ``cuda``-marked tests run the kernels against the plain version on the
  card, bit for bit, and a 10-step priori segment of the survey's sampler
  with the kernels and with the plain ops; they skip without a card.

This file imports no JAX, so on a GPU machine without JAX it runs alone:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_draws.py``.
"""

import ctypes
import inspect
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu_torch import profiling
from pysurfinv_tpu_torch.inversion import mcmc
from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.inversion.compiled import BrownianSpec
from pysurfinv_tpu_torch.ops import draw_lanes as DL
from pysurfinv_tpu_torch.ops.secular_lanes import CSRC

torch.set_num_threads(1)

LANES = [1, 7, 1920, 2049]
WIDTHS = [1, 2, 34, 64]
P = 11


def _keys(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, (n, 2), generator=g, dtype=torch.int64)


def _lanes(M, seed, dtype=torch.float64):
    """(M, P) thetas inside their bounds, with proposal steps from 2% to
    32% of the range: truncations at both ends, as the sampler has."""
    g = torch.Generator().manual_seed(seed)
    r = lambda: torch.rand(M, P, generator=g, dtype=torch.float64)  # noqa
    vmin = 3.0 * r() - 1.0
    vmax = vmin + 0.1 + r()
    theta = vmin + (vmax - vmin) * r()
    step = (vmax - vmin) * (0.02 + 0.3 * r())
    return BrownianSpec(*(x.to(dtype) for x in (theta, vmin, vmax, step)))


def _pert_counts(W):
    """Rounds wholly perturbing, straddling n_perturb_rounds, wholly
    resetting."""
    return sorted({W, W // 2, 0})


def _stream_cases(keys, data):
    """(name, fn(backend)) of every stream call on ``keys`` (n, 2) and
    ``data`` (n,)."""
    return [
        ("fold_in int", lambda b: R.fold_in(keys, 2 * 37, backend=b)),
        ("fold_in wide int", lambda b: R.fold_in(keys, 2 ** 40 + 5,
                                                 backend=b)),
        ("fold_in per key", lambda b: R.fold_in(keys, data, backend=b)),
        ("fold_in one key", lambda b: R.fold_in(keys[0], data, backend=b)),
        ("split 2", lambda b: R.split(keys, backend=b)),
        ("split 5", lambda b: R.split(keys, 5, backend=b)),
        ("bits 32", lambda b: R.random_bits(keys, 32, (3,), backend=b)),
        ("bits 64", lambda b: torch.stack(R.random_bits(keys, 64, (2, 4),
                                                        backend=b))),
    ]


def _data(n):
    return torch.arange(n, dtype=torch.int64) * 7919 + 3


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_keys_take_the_plain_version(monkeypatch):
    def refuse():
        raise AssertionError("the draw library was asked for CPU keys")

    monkeypatch.setattr(DL, "draw_library", refuse)
    DL.reset_launch_counts()
    spec = _lanes(7, 1)
    keys = _keys(7, 2)
    profiling.reset_counters()
    with profiling.counting():
        for _, call in _stream_cases(keys, _data(7)):
            call("auto")
        R.uniform(keys, (3,))
        R.normal(keys, (3,))
        ks, cand = mcmc._draw_round(0, keys, spec.theta0, spec, 2,
                                    mcmc.ChainConfig(n_perturb_rounds=1))
    got = profiling.counters()
    assert got["draw.plain_rounds"] == 1
    assert "draw.kernel_rounds" not in got
    assert [k.launches for k in DL.KERNELS] == [0] * len(DL.KERNELS)
    assert cand.shape == (2, 7, P) and ks.shape == (7, 2)
    with pytest.raises(ValueError, match="CUDA keys"):
        R.split(keys, backend="kernel")
    with pytest.raises(ValueError, match="CUDA keys"):
        mcmc._draw_round(0, keys, spec.theta0, spec, 1, mcmc.ChainConfig(),
                         backend="kernel")
    with pytest.raises(ValueError, match="backend"):
        R.fold_in(keys, 1, backend="cuda")
    profiling.reset_counters()


# ---------------------------------------------------------------------------
# The kernels' arithmetic, compiled for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' lane code for the host")
    so = tmp_path_factory.mktemp("draw_lane_host") / "libhost.so"
    src = Path(__file__).with_name("draw_lane_host.cpp")
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", f"-I{CSRC}",
                    "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    Pt, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.draw_round_host.argtypes = [Pt] * 7 + [I] * 5
    lib.fold_in_host.argtypes = [Pt, I, Pt, ctypes.c_uint32, I, Pt, LL]
    lib.bits_host.argtypes = [Pt, LL, Pt, Pt, LL]
    lib.erf_host.argtypes = [Pt, Pt, LL]
    lib.erfinv_host.argtypes = [Pt, Pt, LL]
    return lib


def _host_streams(lib, name, keys, data):
    """One stream call of ``_stream_cases`` on the host lane code."""
    n = keys.shape[0]
    if name.startswith("fold_in"):
        if name == "fold_in one key":
            k, ks, d, d0 = keys[0].contiguous(), 0, data.data_ptr(), 0
        elif name == "fold_in per key":
            k, ks, d, d0 = keys, 1, data.data_ptr(), 0
        else:
            k, ks, d = keys, 1, None
            d0 = (2 * 37 if name == "fold_in int" else 2 ** 40 + 5) & 0xFFFFFFFF
        out = torch.empty((n, 2), dtype=torch.int64)
        lib.fold_in_host(k.data_ptr(), ks, d, d0, 0, out.data_ptr(), n)
        return out
    if name.startswith("split"):
        num = int(name.split()[1])
        out = torch.empty((n, num, 2), dtype=torch.int64)
        lib.fold_in_host(keys.data_ptr(), 1, None, 0, num, out.data_ptr(),
                         n * num)
        return out
    if name == "bits 32":
        out = torch.empty((n, 3), dtype=torch.int64)
        lib.bits_host(keys.data_ptr(), 3, out.data_ptr(), None, n * 3)
        return out
    out = torch.empty((2, n, 2, 4), dtype=torch.int64)
    lib.bits_host(keys.data_ptr(), 8, out[0].data_ptr(), out[1].data_ptr(),
                  n * 8)
    return out


@pytest.mark.parametrize("n", LANES)
def test_host_streams_match_plain(host_lib, n):
    keys, data = _keys(n, n), _data(n)
    for name, call in _stream_cases(keys, data):
        want = call("plain")
        got = _host_streams(host_lib, name, keys, data)
        assert torch.equal(got, want), name


def _host_round(lib, keys, spec, W, n_pert):
    M = keys.shape[0]
    ko = torch.empty_like(keys)
    cand = torch.empty((W, M, P), dtype=spec.theta0.dtype)
    lib.draw_round_host(keys.data_ptr(), spec.theta0.data_ptr(),
                        spec.step.data_ptr(), spec.vmin.data_ptr(),
                        spec.vmax.data_ptr(), ko.data_ptr(), cand.data_ptr(),
                        M, P, W, n_pert, int(spec.theta0.dtype
                                             == torch.float64))
    return ko, cand


def _ulps(a, b):
    """Float64 ulp distance of a and b (their bits as ordered integers)."""
    def ordered(x):
        i = x.view(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _host_fn(fn):
    def call(x):
        x = x.contiguous()
        y = torch.empty_like(x)
        fn(x.data_ptr(), y.data_ptr(), x.numel())
        return y
    return call


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("M", LANES)
def test_host_round_matches_plain(host_lib, M, W, monkeypatch):
    """A retry round: the walked keys bit for bit; the resets bit for bit;
    the perturbations bit for bit when the plain ops run on the host
    build's erf and erfinv.  Against torch's own CPU erf (SLEEF's
    vectorised erf on all but a tensor's tail) and erfinv (compiled with
    contracted FMAs) their last bits differ, and near a truncation bound
    erfinv's slope magnifies that to hundreds or thousands of ulp of a
    candidate near zero (measured up to 3,283 ulp and 3.2e-12 of the
    step); there the perturbations are held to 1e-10 of the step.  Away
    from both bounds (3 steps or more), where erfinv's slope is moderate
    (|z| < 1), and on candidates that do not cancel (|candidate| at least
    max(|theta|, step)), they are held to 4 ulp (measured at most 2)."""
    spec = _lanes(M, 10 * M + W)
    keys = _keys(M, M + W)
    theta, step = spec.theta0[None], spec.step[None]
    lo = (spec.vmin[None] - theta) / step
    hi = (spec.vmax[None] - theta) / step
    for n_pert in _pert_counts(W):
        cfg = mcmc.ChainConfig(n_perturb_rounds=n_pert + 5)
        ko, got = _host_round(host_lib, keys, spec, W, n_pert)
        kp, want = mcmc._draw_round(5, keys, spec.theta0, spec, W, cfg,
                                    backend="plain")
        assert torch.equal(ko, kp)
        assert torch.equal(got[n_pert:], want[n_pert:])
        g, w = got[:n_pert], want[:n_pert]
        assert bool(((g - w).abs() <= 1e-10 * step).all())
        z = (w - theta) / step
        tame = ((lo < -3) & (hi > 3) & (z.abs() < 1)
                & (w.abs() >= torch.maximum(theta.abs(), step)))
        assert bool((_ulps(g, w)[tame] <= 4).all()), f"n_pert={n_pert}"
        with monkeypatch.context() as mp:
            mp.setattr(torch, "erf", _host_fn(host_lib.erf_host))
            mp.setattr(torch, "erfinv", _host_fn(host_lib.erfinv_host))
            _, same = mcmc._draw_round(5, keys, spec.theta0, spec, W, cfg,
                                       backend="plain")
        assert torch.equal(got, same), f"n_pert={n_pert}"
        inside = (got >= spec.vmin[None]) & (got <= spec.vmax[None])
        assert bool(inside.all())


# ---------------------------------------------------------------------------
# The CUDA kernels (need a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _plain(fn):
    """``fn`` with its ``backend`` forced to the torch ops, however the
    caller passes it."""
    sig = inspect.signature(fn)

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.arguments["backend"] = "plain"
        return fn(*bound.args, **bound.kwargs)
    return call


def _force_plain(mp):
    """Every draw through ``mp`` (a monkeypatch context) on the torch ops:
    the three stream primitives and the retry round."""
    for mod, name in ((R, "fold_in"), (R, "split"), (R, "random_bits"),
                      (mcmc, "_draw_round")):
        mp.setattr(mod, name, _plain(getattr(mod, name)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", LANES)
def test_cuda_streams_match_plain(cuda_device, n, monkeypatch):
    """Every stream call on CUDA keys: one kernel launch, the plain ops'
    bits on the card, and the integer streams' bits on the CPU."""
    keys, data = _keys(n, n), _data(n)
    on_card = _stream_cases(keys.to(cuda_device), data.to(cuda_device))
    DL.reset_launch_counts()
    for (name, call), (_, cpu) in zip(on_card, _stream_cases(keys, data)):
        k, p = call("auto"), call("plain")
        assert k.is_cuda and torch.equal(k, p), name
        assert torch.equal(k.cpu(), cpu("plain")), name
    # fold_in 4, split 2 (on the fold_in kernel), random_bits 2
    assert [k.launches for k in DL.KERNELS] == [0, 6, 2]
    kd = keys.to(cuda_device)
    for dtype in (torch.float64, torch.float32):
        for draw in (lambda: R.uniform(kd, (5,), dtype),
                     lambda: R.normal(kd, (3,), dtype)):
            k = draw()
            with monkeypatch.context() as mp:
                _force_plain(mp)
                p = draw()
            assert torch.equal(k.view(torch.uint8), p.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("M", LANES)
def test_cuda_round_matches_plain(cuda_device, M, W, dtype, monkeypatch):
    spec = BrownianSpec(*(x.to(cuda_device)
                          for x in _lanes(M, 10 * M + W, dtype)))
    keys = _keys(M, M + W).to(cuda_device)
    DL.reset_launch_counts()
    for n_pert in _pert_counts(W):
        cfg = mcmc.ChainConfig(n_perturb_rounds=n_pert + 5)
        kk, ck = mcmc._draw_round(5, keys, spec.theta0, spec, W, cfg)
        with monkeypatch.context() as mp:
            _force_plain(mp)
            kp, cp = mcmc._draw_round(5, keys, spec.theta0, spec, W, cfg)
        torch.cuda.synchronize()
        assert torch.equal(kk, kp)
        assert torch.equal(ck.view(torch.uint8), cp.view(torch.uint8)), \
            f"n_pert={n_pert}"
        # the integer walk is the CPU's
        kc, _ = mcmc._draw_round(5, keys.cpu(), spec.theta0.cpu(),
                                 BrownianSpec(*(x.cpu() for x in spec)), W,
                                 cfg)
        assert torch.equal(kk.cpu(), kc)
    assert DL.draw_round.launches == len(_pert_counts(W))


def _survey_lanes(device, n_points=16, nch=30):
    """The survey cell's priori lanes at the Cascadia example point (the
    cell's configuration), ``n_points`` sediment thicknesses x ``nch``
    chains: (cm, (keys, spec_b, ctx_b, theta0, use_init))."""
    from pysurfinv_tpu_torch.convert import spec_from_numpy
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
    from pysurfinv_tpu_torch.inversion.point import PointCascadia

    mods = [PointCascadia(SETTING, dict(LOCAL, sedthk=s), periods=PERIODS,
                          vels=VELS, uncers=UNCERS).initMod
            for s in np.linspace(0.02, 0.92, n_points)]
    cm = CompiledModel(mods[0])
    specs = [cm.spec_of(m) for m in mods]
    spec = tuple(np.repeat(np.stack([getattr(s, f) for s in specs]), nch, 0)
                 for f in BrownianSpec._fields)
    psi = np.repeat(np.stack([cm.psi_of(m) for m in mods]), nch, 0)
    spec_b, psi_b = spec_from_numpy(spec, psi, device=device)
    n = n_points * nch
    keys = R.fold_in(R.PRNGKey(7130000011), torch.arange(n)).to(device)
    use_init = torch.tensor(np.tile(np.arange(nch) == 0, n_points),
                            device=device)
    return cm, (keys, spec_b, (psi_b,), spec_b.theta0, use_init)


def _segments(cm, lanes, n_steps=10):
    """The survey's prior sampler from its start: segments 0-9 and
    10-19.  Returns the rows, and the counters and the round kernel's
    launches of the second."""
    def no_solve(*_):
        raise AssertionError("prior mode evaluates no likelihood")

    init_fn, seg_fn = mcmc.make_segmented_sampler(
        lambda t, ctx: cm.isgood(t, ctx[0]), no_solve,
        mcmc.ChainConfig(chain_len=800, priori=True))
    keys, spec_b, ctx_b, theta0, use_init = lanes
    carry = init_fn(keys, spec_b, ctx_b, theta0, use_init)
    carry, rows0 = seg_fn(carry, keys, spec_b, ctx_b, 0, n_steps)
    profiling.reset_counters()
    n0 = DL.draw_round.launches
    with profiling.counting():
        carry, rows1 = seg_fn(carry, keys, spec_b, ctx_b, n_steps, n_steps)
    counted = profiling.counters()
    profiling.reset_counters()
    return (torch.cat([rows0, rows1]).cpu(), counted,
            DL.draw_round.launches - n0)


@pytest.mark.cuda
def test_cuda_segment_kernel_equals_plain(cuda_device, monkeypatch):
    """A 10-step priori segment of the survey's sampler on the card, its
    draws by the kernels and by the plain ops: the same rows bit for bit,
    the same candidates judged and host reads."""
    cm, lanes = _survey_lanes(cuda_device)
    rows_k, got_k, launched_k = _segments(cm, lanes)
    assert got_k["draw.kernel_rounds"] == launched_k > 0
    assert "draw.plain_rounds" not in got_k
    _force_plain(monkeypatch)
    launched = [k.launches for k in DL.KERNELS]
    rows_p, got_p, _ = _segments(cm, lanes)
    assert [k.launches for k in DL.KERNELS] == launched
    assert got_p["draw.plain_rounds"] == got_k["draw.kernel_rounds"]
    assert "draw.kernel_rounds" not in got_p
    assert torch.equal(rows_k, rows_p)
    for name in ("propose.candidates", "host_syncs"):
        assert got_k[name] == got_p[name] > 0, name

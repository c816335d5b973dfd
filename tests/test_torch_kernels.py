"""The port's secular-lane kernels: dispatch, their CUDA arithmetic on the
host, and (on a machine with an NVIDIA GPU) the kernels themselves.

* CPU tensors take the plain versions, ``backend="kernel"`` raises there,
  and the launch counters move only where a kernel launches.
* The kernels' per-lane code (``csrc/secular_lane.cuh``) compiled with g++
  agrees with the plain versions at the kernel contract's tolerances
  (skips without g++), refine_lanes' Illinois + Newton body included.
* The lane code takes every shape the kernels' launches give it: ragged
  model counts (B=37, not a multiple of a 128-model block), K of 1, 5 and
  13, dynamic and pinned closures, the value and the dual-number bodies;
  and a lane's bits do not depend on the batch around it.
* refine_lanes' two phases (a float Illinois kernel, then a dual-number
  Newton kernel) with their hand-over going through memory give the
  one-pass lane body's bits.
* ``cuda``-marked tests run the CUDA kernels against the plain versions on
  the card (all four bit for bit, at the ragged shapes too); they skip
  without one.

This file imports no JAX, so on a GPU machine without JAX it runs alone:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_kernels.py``.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_helpers import (eus_batch, load_eus_model, root_brackets,
                           with_water_top)

from pysurfinv_tpu_torch.ops import secular_lanes as tsl
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward_batch
from pysurfinv_tpu_torch.ops.flatten import flatten_factors

torch.set_num_threads(1)

WAVES = ["rayleigh", "love"]
PERIODS = np.array([10.0, 25.0, 60.0, 100.0], np.float32)
PROBES = np.array([[3.0, 3.4, 4.1, 2.9], [3.2, 3.9, 4.4, 3.3],
                   [3.6, 4.05, 4.6, 3.7], [3.8, 4.3, 4.9, 4.0]], np.float32)


@pytest.fixture(scope="module")
def eus():
    return load_eus_model()


@pytest.fixture(scope="module")
def ragged(eus):
    """float32 inputs per wave at ragged shapes: B=37 models (36 jittered
    eus models and one with a water layer on top), K=13 rows of c from 2.7
    to 4.9 km/s over four periods (every regime of both wavenumbers), and
    the pinned closures of a dynamic walk at c + 0.01 (the solver's)."""
    h, vp, vs, rho, qsi, nlay = with_water_top(eus_batch(eus, B=36))
    K, B = 13, h.shape[0]
    c = torch.linspace(2.7, 4.9, K)[:, None].expand(K, B).contiguous()
    t = torch.tensor(PERIODS)[torch.arange(K) % 4][:, None].expand(K, B)
    t = t.contiguous()
    out = {}
    for wave in WAVES:
        fac = flatten_factors(torch.tensor(h), torch.tensor(nlay),
                              1 if wave == "love" else 2)
        model = [torch.tensor(x).T.contiguous() for x in (vp, vs, rho, qsi)]
        model += [x.T.contiguous() for x in fac]
        nl = torch.tensor(nlay)
        _, _, pin = tsl.secular_lanes_plain(
            c + 0.01, t, torch.zeros(c.shape, dtype=torch.int32), *model, nl,
            wave=wave)
        out[wave] = (c, t, pin, model, nl)
    return out


def _rows(ragged, wave, K):
    """The first K rows of the ragged inputs, spread over the 13."""
    c, t, pin, model, nl = ragged[wave]
    idx = torch.linspace(0, c.shape[0] - 1, K).round().long()
    return (c[idx].contiguous(), t[idx].contiguous(), pin[idx].contiguous(),
            model, nl)


def _bits(xs):
    return [x.view(torch.int32) for x in xs]


@pytest.fixture(scope="module")
def lanes(eus):
    """float32 lane inputs per wave: c, t, the (L, B) model, nlay."""
    h, vp, vs, rho, qsi, nlay = with_water_top(eus_batch(eus))
    out = {}
    for wave in WAVES:
        fac = flatten_factors(torch.tensor(h), torch.tensor(nlay),
                              1 if wave == "love" else 2)
        model = [torch.tensor(x).T.contiguous() for x in (vp, vs, rho, qsi)]
        model += [x.T.contiguous() for x in fac]
        t = torch.tensor(PERIODS)[:, None].expand(PROBES.shape).contiguous()
        out[wave] = (torch.tensor(PROBES), t, model, torch.tensor(nlay))
    return out


def _assert_F(Fk, Fp):
    bound = 1e-4 * Fp.abs().amax(dim=0, keepdim=True)
    assert bool(((Fk - Fp).abs() <= bound).all())
    big = Fp.abs() > bound
    assert torch.equal(torch.sign(Fk[big]), torch.sign(Fp[big]))


def _assert_ratio(Gk, Gp):
    rk, rp = Gk[2] / Gk[1], Gp[2] / Gp[1]
    assert bool(((rk - rp).abs()
                 <= 2e-3 * torch.clamp(rp.abs(), min=1e-6)).all())


# ---------------------------------------------------------------------------
# Dispatch on the CPU
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions(lanes):
    c, t, model, nlay = lanes["rayleigh"]
    mm0 = torch.zeros(c.shape, dtype=torch.int32)
    tsl.reset_launch_counts()
    F, bhs, mm = tsl.secular_lanes(c, t, mm0, *model, nlay)
    Fp, _, _ = tsl.secular_lanes_plain(c, t, mm0, *model, nlay)
    assert torch.equal(F, Fp)
    tsl.secular_lanes_frozen(c, t, mm, *model, nlay)
    tsl.secular_lanes_grad(c, t, mm, *model, nlay)
    tsl.refine_lanes(c, c + 0.1, t, mm, *model, nlay, n_ill=1, n_newton=1)
    assert [k.launches for k in tsl.KERNELS] == [0, 0, 0, 0]
    for fn, mmf in ((tsl.secular_lanes, mm0), (tsl.secular_lanes_frozen, mm),
                    (tsl.secular_lanes_grad, mm)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(c, t, mmf, *model, nlay, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tsl.refine_lanes(c, c + 0.1, t, mm, *model, nlay, backend="kernel")


# ---------------------------------------------------------------------------
# The kernels' arithmetic, compiled for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' lane code for the host")
    csrc = Path(tsl.CSRC)
    so = tmp_path_factory.mktemp("secular_lane_host") / "libhost.so"
    src = Path(__file__).with_name("secular_lane_host.cpp")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{csrc}", "-o", str(so), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.secular_lanes_host.argtypes = [P] * 15 + [I, I, I, I, F, F, I]
    lib.secular_lanes_frozen_host.argtypes = [P] * 11 + [I, I, I, I, F, I]
    lib.secular_lanes_grad_host.argtypes = [P] * 13 + [I, I, I, I, F, I]
    lib.refine_lanes_host.argtypes = [P] * 13 + [I, I, I, I, F, I, I, I, I]
    lib.refine_illinois_host.argtypes = [P] * 12 + [I, I, I, I, F, I, I]
    lib.refine_newton_host.argtypes = [P] * 12 + [I, I, I, I, F, I, I, I]
    return lib


def _host_call(lib, kind, wave, c, t, mmf, model, nlay, hi=None):
    """One kernel's lane body over every lane on the host; ``refine``
    takes ``c`` as the brackets' lower ends and ``hi`` as their upper."""
    K, B = c.shape
    L = model[0].shape[0]
    ray = int(wave == "rayleigh")
    p = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
    if kind == "refine":
        root, u = torch.empty_like(c), torch.empty_like(c)
        lib.refine_lanes_host(*p(c, hi, t, mmf, *model, root, u), K, B, L,
                              ray, 1.0, 1, 6, 2, 1)
        return root, u
    if kind == "dynamic":
        F, bhs = torch.empty_like(c), torch.empty_like(c)
        mm = torch.empty_like(mmf)
        lib.secular_lanes_host(*p(c, t, t, mmf, *model, nlay, F, bhs, mm),
                               K, B, L, ray, 4.0, 1.0, 1)
        return F, bhs, mm
    if kind == "frozen":
        F = torch.empty_like(c)
        lib.secular_lanes_frozen_host(*p(c, t, mmf, *model, F), K, B, L,
                                      ray, 1.0, 1)
        return F
    G = [torch.empty_like(c) for _ in range(3)]
    lib.secular_lanes_grad_host(*p(c, t, mmf, *model, *G), K, B, L, ray,
                                1.0, 1)
    return G


@pytest.mark.parametrize("wave", WAVES)
def test_kernel_lane_code_on_host_matches_plain(host_lib, lanes, wave):
    c, t, model, nlay = lanes[wave]
    for mmf in (torch.zeros(c.shape, dtype=torch.int32),
                torch.full(c.shape, 12, dtype=torch.int32)):
        Fk, bk, mk = _host_call(host_lib, "dynamic", wave, c, t, mmf, model,
                                nlay)
        Fp, bp, mp = tsl.secular_lanes_plain(c, t, mmf, *model, nlay,
                                             wave=wave)
        assert torch.equal(mk, mp)
        torch.testing.assert_close(bk, bp, rtol=1e-6, atol=0)
        _assert_F(Fk, Fp)
    _, _, mm = tsl.secular_lanes_plain(c, t, torch.zeros_like(mmf), *model,
                                       nlay, wave=wave)
    _assert_F(_host_call(host_lib, "frozen", wave, c, t, mm, model, nlay),
              tsl.secular_lanes_frozen_plain(c, t, mm, *model, nlay,
                                             wave=wave))
    Gk = _host_call(host_lib, "grad", wave, c, t, mm, model, nlay)
    Gp = tsl.secular_lanes_grad_plain(c, t, mm, *model, nlay, wave=wave)
    _assert_F(Gk[0], Gp[0])
    _assert_ratio(Gk, Gp)


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("K", [1, 5, 13])
@pytest.mark.parametrize("kind", ["dynamic", "pinned", "grad"])
def test_lane_code_on_host_ragged_shapes(host_lib, ragged, wave, K, kind):
    """The kernels' lane code at the ragged shapes of their launches, held
    to the plain versions as above (the host's libm and PyTorch's CPU
    kernels round expf/sincosf differently, so not bit for bit)."""
    c, t, pin, model, nl = _rows(ragged, wave, K)
    if kind == "grad":
        Gk = _host_call(host_lib, "grad", wave, c, t, pin, model, nl)
        Gp = tsl.secular_lanes_grad_plain(c, t, pin, *model, nl, wave=wave)
        _assert_F(Gk[0], Gp[0])
        _assert_ratio(Gk, Gp)
        return
    mmf = torch.zeros_like(pin) if kind == "dynamic" else pin
    Fk, bk, mk = _host_call(host_lib, "dynamic", wave, c, t, mmf, model, nl)
    Fp, bp, mp = tsl.secular_lanes_plain(c, t, mmf, *model, nl, wave=wave)
    assert torch.equal(mk, mp)
    torch.testing.assert_close(bk, bp, rtol=1e-6, atol=0)
    _assert_F(Fk, Fp)


def _random_brackets(c, seed):
    """Brackets around ``c``: lower ends within 0.1 km/s of it, widths
    0.005-0.2 km/s, drawn from a numpy generator (most hold no root; the
    lane code runs the same steps either way)."""
    rng = np.random.default_rng(seed)
    lo = c + torch.tensor(rng.uniform(-0.1, 0.1, c.shape), dtype=c.dtype)
    hi = lo + torch.tensor(rng.uniform(0.005, 0.2, c.shape), dtype=c.dtype)
    return lo.contiguous(), hi.contiguous()


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("kind", ["dynamic", "pinned", "frozen", "grad",
                                  "refine"])
def test_host_lane_code_is_batch_invariant(host_lib, ragged, wave, kind):
    """A lane's bits do not depend on the batch around it: the (13, 37)
    batch equals each model alone (B=1) and each row alone (K=1), bit for
    bit.  The kernels rely on it when they lay out the same lanes in
    another grid order."""
    c, t, pin, model, nl = ragged[wave]
    K, B = c.shape
    mmf = torch.zeros_like(pin) if kind == "dynamic" else pin
    call = "dynamic" if kind in ("dynamic", "pinned") else kind
    lo, hi = _random_brackets(c, seed=5) if kind == "refine" else (c, None)

    def run(rows, cols):
        sub = lambda x: x[rows][:, cols].contiguous()  # noqa: E731
        out = _host_call(host_lib, call, wave, sub(lo), sub(t), sub(mmf),
                         [m[:, cols].contiguous() for m in model],
                         nl[cols].contiguous(),
                         hi=None if hi is None else sub(hi))
        return list(out) if isinstance(out, (tuple, list)) else [out]

    whole = run(slice(None), slice(None))
    for b in range(B):
        one = run(slice(None), slice(b, b + 1))
        for x, y in zip(whole, one):
            assert torch.equal(x[:, b:b + 1].view(torch.int32),
                               y.view(torch.int32))
    for k in range(K):
        one = run(slice(k, k + 1), slice(None))
        for x, y in zip(whole, one):
            assert torch.equal(x[k:k + 1].view(torch.int32),
                               y.view(torch.int32))


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("n_newton", [0, 2])
def test_refine_lane_code_on_host_matches_plain(host_lib, lanes, wave,
                                                n_newton):
    """The refine kernel's lane body (Illinois + Newton + u) against
    refine_lanes_plain on brackets around each lane's root.  The host
    build's libm (expf, sinf) rounds differently from PyTorch's CPU
    kernels, and F at a root is float32 noise, so a lane may settle on
    another point of its noise band: roots within 1e-4 km/s (the card
    contract's bound), u within 1e-3 relative at q99."""
    c, t, model, nlay = lanes[wave]
    lo, hi, mm = root_brackets(c, t, model, nlay, wave)
    K, B = lo.shape
    root, u = torch.empty_like(lo), torch.empty_like(lo)
    p = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
    host_lib.refine_lanes_host(*p(lo, hi, t, mm, *model, root, u), K, B,
                               model[0].shape[0], int(wave == "rayleigh"),
                               1.0, 1, 6, n_newton, 1)
    rp, up = tsl.refine_lanes_plain(lo, hi, t, mm, *model, nlay, wave=wave,
                                    n_ill=6, n_newton=n_newton)
    assert float((root - rp).abs().max()) <= 1e-4
    if n_newton:
        rel = ((u - up).abs() / up.abs()).double()
        assert float(torch.quantile(rel, 0.99)) <= 1e-3
    assert (n_newton == 0) == bool((up == 0).all())


@pytest.mark.parametrize("wave", WAVES)
@pytest.mark.parametrize("K", [1, 5, 13])
@pytest.mark.parametrize("n_newton", [0, 1, 2])
def test_refine_phases_through_memory_equal_one_pass(host_lib, ragged, wave,
                                                     K, n_newton):
    """refine_lanes' two kernels (the float Illinois phase, then the
    dual-number Newton phase) with their hand-over (lo, hi, x, sgn F(lo))
    going through memory give the one-pass lane body's bits, on random
    brackets at ragged shapes, with and without the group velocity."""
    c, t, pin, model, nl = _rows(ragged, wave, K)
    lo, hi = _random_brackets(c, seed=100 * K + n_newton)
    B, L = c.shape[1], model[0].shape[0]
    ray = int(wave == "rayleigh")
    p = lambda *xs: [x.data_ptr() for x in xs]  # noqa: E731
    for group in (1, 0):
        one = [torch.empty_like(c) for _ in range(2)]
        host_lib.refine_lanes_host(*p(lo, hi, t, pin, *model, *one), K, B, L,
                                   ray, 1.0, 1, 6, n_newton, group)
        state = torch.full((K, B, 4), float("nan"))
        host_lib.refine_illinois_host(*p(lo, hi, t, pin, *model, state), K,
                                      B, L, ray, 1.0, 1, 6)
        two = [torch.empty_like(c) for _ in range(2)]
        host_lib.refine_newton_host(*p(state, t, pin, *model, *two), K, B, L,
                                    ray, 1.0, 1, n_newton, group)
        assert all(torch.equal(x, y) for x, y in zip(_bits(one), _bits(two)))
        assert bool(torch.isfinite(one[0]).all())
        if n_newton == 0:
            # the Illinois phase's estimate is the root, as its kernel
            # writes it when no Newton phase follows
            assert torch.equal(_bits([state[..., 2]])[0], _bits(one[:1])[0])
        assert bool((one[1] == 0).all()) == (n_newton == 0 or not group)


# ---------------------------------------------------------------------------
# The CUDA kernels (need a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("wave", WAVES)
def test_cuda_kernels_match_plain(cuda_device, lanes, ragged, wave):
    c, t, model, nlay = (x.to(cuda_device) if torch.is_tensor(x)
                         else [m.to(cuda_device) for m in x]
                         for x in lanes[wave])
    mm0 = torch.zeros(c.shape, dtype=torch.int32, device=cuda_device)
    tsl.reset_launch_counts()
    Fk, bk, mk = tsl.secular_lanes(c, t, mm0, *model, nlay, wave=wave)
    Fp, bp, mp = tsl.secular_lanes(c, t, mm0, *model, nlay, wave=wave,
                                   backend="plain")
    torch.cuda.synchronize()
    assert torch.equal(mk, mp)
    torch.testing.assert_close(bk, bp, rtol=1e-6, atol=0)
    _assert_F(Fk, Fp)
    _assert_F(tsl.secular_lanes_frozen(c, t, mp, *model, nlay, wave=wave),
              tsl.secular_lanes_frozen(c, t, mp, *model, nlay, wave=wave,
                                       backend="plain"))
    Gk = tsl.secular_lanes_grad(c, t, mp, *model, nlay, wave=wave)
    Gp = tsl.secular_lanes_grad(c, t, mp, *model, nlay, wave=wave,
                                backend="plain")
    torch.cuda.synchronize()
    _assert_F(Gk[0], Gp[0])
    _assert_ratio(Gk, Gp)
    lo, hi, mm = root_brackets(*(x.cpu() if torch.is_tensor(x)
                                 else [m.cpu() for m in x]
                                 for x in lanes[wave]), wave)
    lo, hi, mm = lo.to(cuda_device), hi.to(cuda_device), mm.to(cuda_device)
    Rk = tsl.refine_lanes(lo, hi, t, mm, *model, nlay, wave=wave)
    Rp = tsl.refine_lanes(lo, hi, t, mm, *model, nlay, wave=wave,
                          backend="plain")
    torch.cuda.synchronize()
    assert torch.equal(Rk[0], Rp[0]) and torch.equal(Rk[1], Rp[1])
    assert [k.launches for k in tsl.KERNELS] == [1, 1, 1, 1]
    with pytest.raises(TypeError, match="float32"):
        tsl.secular_lanes(c.double(), t.double(), mm0,
                          *[m.double() for m in model], nlay)
    # every kernel bit for bit at the main shapes above and at ragged ones
    assert all(torch.equal(x, y)
               for x, y in zip(_bits((Fk, bk)), _bits((Fp, bp))))
    assert all(torch.equal(x, y) for x, y in zip(_bits(Gk), _bits(Gp)))
    for K in (1, 5, 13):
        rc, rt, pin, rmodel, rnl = (
            x.to(cuda_device) if torch.is_tensor(x)
            else [m.to(cuda_device) for m in x]
            for x in _rows(ragged, wave, K))
        for mmf in (torch.zeros_like(pin), pin):
            k = tsl.secular_lanes(rc, rt, mmf, *rmodel, rnl, wave=wave)
            p = tsl.secular_lanes(rc, rt, mmf, *rmodel, rnl, wave=wave,
                                  backend="plain")
            assert torch.equal(k[2], p[2])
            assert all(torch.equal(x, y)
                       for x, y in zip(_bits(k[:2]), _bits(p[:2])))
        k = tsl.secular_lanes_grad(rc, rt, pin, *rmodel, rnl, wave=wave)
        p = tsl.secular_lanes_grad(rc, rt, pin, *rmodel, rnl, wave=wave,
                                   backend="plain")
        assert all(torch.equal(x, y) for x, y in zip(_bits(k), _bits(p)))
        k = tsl.secular_lanes_frozen(rc, rt, pin, *rmodel, rnl, wave=wave)
        p = tsl.secular_lanes_frozen(rc, rt, pin, *rmodel, rnl, wave=wave,
                                     backend="plain")
        assert torch.equal(*_bits((k, p)))
        lo, hi = (x.to(cuda_device)
                  for x in _random_brackets(rc.cpu(), seed=K))
        for n_newton in (0, 1, 2):
            for group in (True, False):
                k, p = (tsl.refine_lanes(lo, hi, rt, pin, *rmodel, rnl,
                                         wave=wave, n_ill=6,
                                         n_newton=n_newton,
                                         compute_group=group, backend=b)
                        for b in ("kernel", "plain"))
                assert all(torch.equal(x, y)
                           for x, y in zip(_bits(k), _bits(p)))


@pytest.mark.cuda
def test_cuda_solve_matches_plain(cuda_device, eus):
    batch = eus_batch(eus, B=8)
    args = [torch.tensor(x, device=cuda_device) for x in batch]
    per = torch.tensor(PERIODS, device=cuda_device)
    ck, uk, okk = surf_forward_batch(*args[:5], per, args[5])
    cp, up, okp = surf_forward_batch(*args[:5], per, args[5],
                                     cfg=SurfConfig(backend="plain"))
    assert torch.equal(okk, okp) and bool(okk.all())
    assert float((ck - cp).abs().max()) < 1e-4

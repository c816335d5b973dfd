"""Port parity of the per-chain ("legacy") sampler, float64 on the CPU.

``make_chain_kernel`` / ``run_chains`` and ``Point.MCinvMP(sampler=
"legacy")`` against the JAX package's with the same seed, in prior mode
and with the forward (the single-model float64 solve): thetas within
1e-10, accept flags equal, misfits within 1e-9 relative — the two
packages' float64 solves agree to ~1e-12 relative on these models
(tests/test_torch_point.py holds them to 1e-8 absolute), so an accept
decision can flip only on a tie no seed here comes near; the proposals
are the same counter-based draws, equal to rounding.  ``invert_grid(
sampler="legacy")`` on 2 points writes the tracks of each point's own
``run_chains`` call with its key, on one device and split over two
processes.  5 periods and the sediment at 0.5 km (tests/test_torch_point
.py) keep the JAX solve to one compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS

from pysurfinv_tpu.inversion import mcmc as jmcmc
from pysurfinv_tpu.inversion.compiled import CompiledModel as JaxCompiled
from pysurfinv_tpu.inversion.point import PointCascadia as JaxPoint
from pysurfinv_tpu_torch.convert import spec_from_numpy
from pysurfinv_tpu_torch.inversion import mcmc as tmcmc
from pysurfinv_tpu_torch.inversion import random as R
from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
from pysurfinv_tpu_torch.inversion.point import PointCascadia
from pysurfinv_tpu_torch.parallel.grid import invert_grid, legacy_chi_sqr_fn

torch.set_num_threads(1)

T5, V5, U5 = PERIODS[::4], VELS[::4], UNCERS[::4]
CPU = dict(device="cpu")


def _point(cls, sed=0.5):
    return cls(SETTING, dict(LOCAL, sedthk=sed), periods=T5, vels=V5,
               uncers=U5)


def _track(d, pid):
    return np.load(f"{d}/{pid}.npz", allow_pickle=True)["mcTrack"]


def _assert_tracks(got, ref):
    np.testing.assert_allclose(got[:, 3:], ref[:, 3:], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(got[:, 2], ref[:, 2])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=1e-9, atol=0)
    np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=1e-9, atol=1e-300)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's legacy MCinvMP, prior mode (runN 12, chainL 4)
    and with the forward (runN 8, chainL 4), once per module."""
    d = tmp_path_factory.mktemp("jax")
    p = _point(JaxPoint)
    p.MCinvMP(str(d / "pri"), pid="p", runN=12, chainL=4, seed=3,
              priori=True, sampler="legacy", verbose=False)
    p.MCinvMP(str(d / "fwd"), pid="p", runN=8, chainL=4, seed=3,
              sampler="legacy", verbose=False)
    return {"priori": _track(d / "pri_priori", "p"),
            "forward": _track(d / "fwd", "p")}


@pytest.mark.parametrize("mode", ["priori", "forward"])
def test_mcinvmp_legacy_matches_jax(jax_runs, tmp_path, mode):
    priori = mode == "priori"
    runN = 12 if priori else 8
    out = str(tmp_path / "t")
    _point(PointCascadia).MCinvMP(out, pid="p", runN=runN, chainL=4,
                                  seed=3, priori=priori, sampler="legacy",
                                  verbose=False, **CPU)
    got = _track(out + ("_priori" if priori else ""), "p")
    ref = jax_runs[mode]
    assert got.shape == ref.shape == (runN, 9)
    _assert_tracks(got, ref)
    if priori:
        np.testing.assert_array_equal(got[:, :3], ref[:, :3])
    else:
        assert (got[:, 0] < 88888).all()
        assert 0 < got[:, 2].sum() < len(got)  # accepts and rejects


def test_run_chains_matches_jax():
    """``run_chains`` of the prior kernel on 6 chains of 5 steps: each
    chain's key, start model and proposals are the JAX package's."""
    jcm = JaxCompiled(_point(JaxPoint).initMod)
    tcm = CompiledModel(_point(PointCascadia).initMod)
    cfg_j = jmcmc.ChainConfig(chain_len=5, priori=True)
    kj = jmcmc.make_chain_kernel(lambda th, psi: jcm.isgood(th, psi),
                                 None, cfg_j)
    ref = np.asarray(jmcmc.run_chains(kj, jax.random.PRNGKey(17), jcm.spec,
                                      jnp.asarray(jcm.psi0), 6))
    cfg_t = tmcmc.ChainConfig(chain_len=5, priori=True)
    kt = tmcmc.make_chain_kernel(lambda th, ctx: tcm.isgood(th, ctx[0]),
                                 None, cfg_t)
    spec, psi = spec_from_numpy(tcm.spec, tcm.psi0, device="cpu")
    got = tmcmc.run_chains(kt, R.PRNGKey(17), spec, (psi,), 6).numpy()
    assert got.shape == ref.shape == (6, 5, 9)
    np.testing.assert_array_equal(got[..., :3], ref[..., :3])
    np.testing.assert_allclose(got[..., 3:], ref[..., 3:], rtol=0,
                               atol=1e-10)
    assert len(np.unique(got[:, :, 3])) > 6  # the chains move


def test_invert_grid_legacy_equals_per_point_calls(tmp_path):
    """Point k's lanes in ``invert_grid(sampler="legacy")`` take the
    keys ``split(fold_in(PRNGKey(seed), k), n_chains)``: its tracks are
    those of ``run_chains`` on the point alone with that key, with one
    device and with the lanes split over two processes."""
    pts = [_point(PointCascadia, sed) for sed in (0.5, 0.6)]
    lls = [(229.0, 46.0), (229.5, 46.0)]
    kw = dict(runN=6, chainL=3, seed=4, sampler="legacy", verbose=False)
    one = invert_grid(pts, lls, outdir=str(tmp_path / "one"), **kw, **CPU)
    two = invert_grid(pts, lls, outdir=str(tmp_path / "two"),
                      device=["cpu", "cpu"], **kw)
    cfg = tmcmc.ChainConfig(chain_len=3)
    for k, (p, f1, f2) in enumerate(zip(pts, one, two)):
        cm = CompiledModel(p.initMod)
        spec, psi = spec_from_numpy(cm.spec_of(p.initMod),
                                    cm.psi_of(p.initMod), device="cpu")
        obs = tuple(torch.as_tensor(x) for x in p._obs_arrays())
        kern = tmcmc.make_chain_kernel(
            lambda th, ctx, cm=cm: cm.isgood(th, ctx[0]),
            legacy_chi_sqr_fn(cm, PointCascadia, "rayleigh"), cfg)
        key = R.fold_in(R.PRNGKey(4), k)
        ref = tmcmc.run_chains(kern, key, spec, (psi, *obs), 2)
        ref = ref.reshape(6, -1).numpy()
        for f in (f1, f2):
            got = np.load(f, allow_pickle=True)["mcTrack"]
            np.testing.assert_array_equal(got, ref)
        assert (ref[:, 0] < 88888).all()

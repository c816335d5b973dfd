"""Port parity of the batched dispersion solve ``surf_forward_batch``.

float32: the port on the CPU (the kernels' plain versions) against the
JAX package's fast path with its Pallas kernels in interpret mode, on
the same numpy batch — identical ok masks, |dc| < 5e-5 km/s and
|du| < 5e-4 km/s (the bounds of tests/test_pallas_secular.py:192-194).

float64: the port against the TEST1 golden curves with the bounds of
``test_fundamental_tight`` (tests/test_dispersion_golden.py:102-111).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import eus_batch

from pysurfinv_tpu.ops.dispersion import SurfConfig as JaxConfig
from pysurfinv_tpu.ops.dispersion import surf_forward_batch as jax_solve
from pysurfinv_tpu_torch.convert import model_batch_from_numpy
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward_batch

torch.set_num_threads(1)

PERIODS = np.array([10.0, 20.0, 40.0, 80.0], np.float32)


def solve_both(batch, periods, wave, c_warm=None, **kw):
    """(JAX, port) outputs of one solve on the same numpy inputs."""
    h, vp, vs, rho, qsi, nlay = batch
    cj, uj, okj = jax_solve(
        *map(jnp.asarray, (h, vp, vs, rho, qsi)), jnp.asarray(periods),
        jnp.asarray(nlay), wave=wave,
        cfg=JaxConfig(backend="pallas_interpret", **kw),
        c_warm=None if c_warm is None else jnp.asarray(c_warm))
    *model, nl = model_batch_from_numpy(h, vp, vs, rho, qsi, nlay,
                                         device="cpu")
    ct, ut, okt = surf_forward_batch(
        *model, torch.tensor(periods), nl, wave=wave, cfg=SurfConfig(**kw),
        c_warm=None if c_warm is None else torch.tensor(c_warm))
    return ((np.asarray(cj), np.asarray(uj), np.asarray(okj)),
            (ct.numpy(), ut.numpy(), okt.numpy()))


def assert_same_solution(jax_out, port_out):
    (cj, uj, okj), (ct, ut, okt) = jax_out, port_out
    assert ct.shape == cj.shape and ct.dtype == cj.dtype
    np.testing.assert_array_equal(okt, okj)
    assert okj.all()
    assert np.abs(ct - cj).max() < 5e-5
    assert np.abs(ut - uj).max() < 5e-4


@pytest.fixture(scope="module")
def batch(eus_model):
    return eus_batch(eus_model)


@pytest.mark.parametrize("wave,periods,kw", [
    ("rayleigh", PERIODS, {}),
    ("love", PERIODS, {}),
    # the refinement seeded with the sweep's endpoint values
    ("rayleigh", PERIODS, dict(fhandoff=True)),
    # overtone chain (the 0.1 dc duplicate-mode guard), as
    # tests/test_pallas_secular.py:197-219
    ("rayleigh", PERIODS[:1] * np.array([1.0, 1.5], np.float32),
     dict(nmodes=2)),
], ids=["rayleigh", "love", "rayleigh_fhandoff", "rayleigh_nmodes2"])
def test_slice_matches_jax_f32(batch, wave, periods, kw):
    jax_out, port_out = solve_both(batch, periods, wave, **kw)
    assert_same_solution(jax_out, port_out)
    if kw.get("nmodes", 1) > 1:
        assert (np.diff(port_out[0], axis=2) > 0).all()


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_golden_fundamental_f64(eus_model, golden, wave):
    """float64 plain path vs TEST1: phase to 1e-5 and group to 5e-5 of
    the curve's maximum (test_fundamental_tight).

    nbisect=20: the group velocity is evaluated at the Illinois root
    before the Newton polish, and u amplifies a root error ~1000x; the
    default 12 iterations (tuned to the float32 noise floor) leave the
    float64 root up to 1e-5 km/s off (u up to 1e-4 off, the same digits
    as the JAX fast path), 20 bring it below 1e-7."""
    m = eus_model
    args = [torch.tensor(np.asarray(m[k], np.float64))[None]
            for k in ("h", "vp", "vs", "rho", "qsinv")]
    c, u, ok = surf_forward_batch(
        *args, torch.tensor(m["periods"]), torch.tensor([m["nlay"]]),
        wave=wave, cfg=SurfConfig(nbisect=20))
    assert c.dtype == torch.float64
    c, u, ok = c[0, :, 0].numpy(), u[0, :, 0].numpy(), ok[0, :, 0].numpy()
    wt = "R" if wave == "rayleigh" else "L"
    refc = golden[f"phv_{wt}_0"][:, 1]
    refu = golden[f"grv_{wt}_0"][:, 1]
    assert ok.all()
    assert np.abs(c - refc).max() / refc.max() < 1e-5
    assert np.abs(u - refu).max() / refu.max() < 5e-5

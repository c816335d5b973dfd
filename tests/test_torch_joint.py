"""Port parity of the joint Rayleigh + Love solve ``surf_forward_joint``.

float32 on the CPU: the port's plain versions against the JAX package's
joint solve with its Pallas kernels in interpret mode, on the batch of
tests/test_joint_forward.py (B = 4, 5 periods, ``nsub=2``): equal ok
masks, |dc| <= 5e-5 km/s, |du| <= 5e-4 km/s.  Within the port: the joint
Love side is bit for bit the independent Love solve, the joint Rayleigh
roots lie within 5e-5 km/s of the independent Rayleigh solve.  The
median of the calibration offset averages the two middle values as
``np.nanmedian`` does, and a NaN seed (a period with no valid
calibration lane) falls back to the cold solve.
"""

import warnings
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysurfinv_tpu.ops.dispersion import SurfConfig as JaxConfig
from pysurfinv_tpu.ops.dispersion import surf_forward_joint as jax_joint
from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _nanmedian,
                                                surf_forward_batch,
                                                surf_forward_joint)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jbatch(eus_model):
    """tests/test_joint_forward.py:15-31, float32."""
    m = eus_model
    B = 4
    rng = np.random.default_rng(11)
    tile = lambda x: np.tile(np.asarray(x)[None], (B, 1))  # noqa: E731
    vs = tile(m["vs"]) * (1 + 0.004 * rng.standard_normal((B, len(m["vs"]))))
    arrs = tuple(np.asarray(x, np.float32) for x in (
        tile(m["h"]), tile(m["vp"]), vs, tile(m["rho"]), tile(m["qsinv"])))
    return (arrs, np.asarray(m["periods"], np.float32)[:5],
            np.full(B, m["nlay"], np.int32))


CFG = SurfConfig(nmodes=1)
CFG_L = replace(CFG, nbisect=CFG.nbisect - 2)


@pytest.fixture(scope="module")
def port_out(jbatch):
    arrs, per, nl = jbatch
    args = (*map(torch.tensor, arrs), torch.tensor(per), torch.tensor(nl))
    joint = surf_forward_joint(*args, cfg=CFG, cfg_love=CFG_L, nsub=2)
    cold_r = surf_forward_batch(*args, wave="rayleigh", cfg=CFG)
    cold_l = surf_forward_batch(*args, wave="love", cfg=CFG_L)
    return [x.numpy() for x in joint], cold_r, cold_l, args


def test_joint_matches_jax_pallas_interpret(jbatch, port_out):
    arrs, per, nl = jbatch
    cfg = JaxConfig(nmodes=1, backend="pallas_interpret")
    ref = jax_joint(*map(jnp.asarray, arrs), jnp.asarray(per),
                    jnp.asarray(nl), cfg=cfg,
                    cfg_love=cfg._replace(nbisect=cfg.nbisect - 2), nsub=2)
    ref = [np.asarray(x) for x in ref]
    got = port_out[0]
    for i in (2, 5):  # okR, okL
        np.testing.assert_array_equal(got[i], ref[i])
        assert ref[i].all()
    for i in (0, 3):  # cR, cL
        assert got[i].dtype == ref[i].dtype == np.float32
        assert np.abs(got[i] - ref[i]).max() <= 5e-5
    for i in (1, 4):  # uR, uL
        assert np.abs(got[i] - ref[i]).max() <= 5e-4


def test_joint_against_independent_solves(port_out):
    (cR, uR, okR, cL, uL, okL), cold_r, cold_l, _ = port_out
    np.testing.assert_array_equal(cL, cold_l[0].numpy())
    np.testing.assert_array_equal(uL, cold_l[1].numpy())
    np.testing.assert_array_equal(okL, cold_l[2].numpy())
    np.testing.assert_array_equal(okR, cold_r[2].numpy())
    assert okR.all()
    assert np.abs(cR - cold_r[0].numpy()).max() <= 5e-5


def test_joint_overtones_take_independent_solves(port_out):
    """nmodes != 1: two independent solves, as in the JAX package."""
    *model, per, nl = (x[:2] for x in port_out[3])   # 2 models, 2 periods
    cfg = replace(CFG, nmodes=2, compute_group=False)
    joint = surf_forward_joint(*model, per, nl, cfg=cfg)
    for out, wave in ((joint[:3], "rayleigh"), (joint[3:], "love")):
        ind = surf_forward_batch(*model, per, nl, wave=wave, cfg=cfg)
        for a, b in zip(out, ind):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [4, 5])
def test_nanmedian_matches_numpy(n):
    """Even and odd valid counts with NaNs, and an all-NaN column, in
    float64 and float32: ``np.nanmedian`` (the mean of the two middle
    values, where ``torch.nanmedian`` returns the lower one)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n + 3, 4))
    x[rng.permutation(n + 3)[:3], 0] = np.nan   # n valid values
    x[:2, 1] = np.nan                            # n + 1 valid values
    x[:, 2] = np.nan                             # none
    for dt in (np.float64, np.float32):
        xd = x.astype(dt)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            ref = np.nanmedian(xd, axis=0)
        got = _nanmedian(torch.tensor(xd)).numpy()
        assert got.dtype == dt
        np.testing.assert_array_equal(got, ref)
    even = x[:, 0] if n % 2 == 0 else x[:, 1]
    assert torch.nanmedian(torch.tensor(even)).item() != np.nanmedian(even)


def test_nan_seed_falls_back_to_cold(port_out):
    """A NaN row of ``c_warm`` (the seed of a period without a valid
    calibration lane) never counts as a found bracket: that model's
    result is the cold solve's, bit for bit."""
    _, cold_r, _, args = port_out
    per = args[5][:3]
    cfg = replace(CFG, wseed_nscan=8, wseed_backoff=4, compute_group=False)
    cold = surf_forward_batch(*args[:5], per, args[6], wave="rayleigh",
                              cfg=cfg)
    c_warm = cold_r[0][:, :3, 0].clone()
    c_warm[1] = float("nan")
    c_warm[2, 1] = float("nan")
    seeded = surf_forward_batch(*args[:5], per, args[6], wave="rayleigh",
                                cfg=cfg, c_warm=c_warm)
    for a, b in zip(seeded, cold):
        assert torch.equal(a[1], b[1])
        assert torch.equal(a[2, 1], b[2, 1])
    assert seeded[2].all()
    assert (seeded[0][[0, 3]] - cold[0][[0, 3]]).abs().max() <= 5e-5

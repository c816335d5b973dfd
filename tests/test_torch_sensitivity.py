"""Port parity of ``sensitivity_kernels`` (phase, group, apparent Q),
float64 on the CPU.

Against the JAX package's ``sensitivity_kernels`` on the same numpy
inputs, Rayleigh and Love, ``nmodes`` 1 and 2, ``group=True``, T = 10, 30,
60 s, on the TEST1 eus model and on that model under a 2 km water layer
(``torch_helpers.with_water_top``): equal ``valid``, every phase kernel
within 1e-7 of its max, the group kernels and ``q_app`` within 1e-6.
Each JAX oracle is computed once per (wave, nmodes) and model: its
compile dominates, and ``nlay`` is traced, so both models share it.
The checks of the port against its own forward and the goldens are in
tests/test_torch_sensitivity_fd.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import with_water_top

from pysurfinv_tpu.ops import dispersion as jd
from pysurfinv_tpu.ops import kernels as jk
from pysurfinv_tpu_torch.ops import kernels as tk
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig

torch.set_num_threads(1)

KEYS = ("h", "vp", "vs", "rho", "qsinv")
PERIODS = np.array([10.0, 30.0, 60.0])
PHASE = ("dc_dvs", "dc_dvp", "dc_drho", "dc_dh")
GROUP = ("du_dvs", "du_dvp", "du_drho")


@pytest.fixture(scope="module")
def models(eus_model):
    m = eus_model
    batch = with_water_top(tuple(np.asarray(m[k])[None] for k in KEYS)
                           + (np.array([m["nlay"]]),))
    water = {k: batch[i][1] for i, k in enumerate(KEYS)}
    water["nlay"] = int(batch[5][1])
    return {"eus": m, "water": water}


def _port(m, wave, **cfg):
    return tk.sensitivity_kernels(
        *(torch.tensor(np.asarray(m[k], np.float64)) for k in KEYS),
        torch.tensor(PERIODS), m["nlay"], wave=wave, cfg=SurfConfig(**cfg),
        group=True)


@pytest.fixture(scope="module")
def jax_kernels(models):
    """JAX oracles, computed on first use and kept for the module."""
    cache = {}

    def get(wave, nmodes, name):
        key = (wave, nmodes, name)
        if key not in cache:
            m = models[name]
            res = jk.sensitivity_kernels(
                *(jnp.asarray(m[k]) for k in KEYS), jnp.asarray(PERIODS),
                m["nlay"], wave=wave, cfg=jd.SurfConfig(nmodes=nmodes),
                group=True)
            cache[key] = res._asdict()
        return {k: np.asarray(v) for k, v in cache[key].items()}
    return get


@pytest.mark.parametrize("model", ["eus", "water"])
@pytest.mark.parametrize("nmodes", [1, 2])
@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_kernels_match_jax(models, jax_kernels, wave, nmodes, model):
    ref = jax_kernels(wave, nmodes, model)
    res = _port(models[model], wave, nmodes=nmodes)
    assert isinstance(res, tk.KernelResult)
    out = {k: v.numpy() for k, v in res._asdict().items()}
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    assert ref["valid"].all()
    for name, tol in ([(k, 1e-7) for k in ("c",) + PHASE]
                      + [(k, 1e-6) for k in ("u", "q_app") + GROUP]):
        assert out[name].shape == ref[name].shape, name
        assert out[name].dtype == np.float64, name
        assert np.isfinite(out[name]).all(), name
        scale = np.abs(ref[name]).max()
        if scale == 0.0:                  # Love: no Vp dependence
            assert np.abs(out[name]).max() == 0.0, name
            continue
        err = np.abs(out[name] - ref[name]).max() / scale
        assert err <= tol, f"{name}: {err:.2e} of max > {tol:.0e}"

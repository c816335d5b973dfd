"""Port parity of the kernel products: ``kernel_densities``, the
user-facing ``SensKernel`` / ``SensKernelPert`` and the PREM table,
float64 on the CPU.

* ``kernel_densities(group=True)`` against the JAX package's, within 1e-6
  of each density's max: Rayleigh with ``nmodes=2`` at T = 10, 20, 30 s
  on the 731-sample grid ``SensKernel`` uses for the TEST1 model (so the
  JAX compile is shared with the class below), Love at T = 10, 30, 60 s.
* ``SensKernel`` "ad" and "eigen" on the TEST1 model and ``SensKernelPert``
  on its first 12 layers (Rayleigh, ``Tmin=10, Tmax=30, Tstep=10``,
  ``endmode=1``), each given as a DataFrame and as a dict of numpy
  columns: ``kernel_phv`` / ``kernel_grv`` / ``kernel`` within 1e-6 of
  their max, NaN in the same places.
* ``prem_model()`` equal to the JAX package's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from pysurfinv_tpu import senskernel as js
from pysurfinv_tpu.data.prem import prem_model as jax_prem
from pysurfinv_tpu.ops import dispersion as jd
from pysurfinv_tpu.ops import kernels as jk
from pysurfinv_tpu_torch import senskernel as ts
from pysurfinv_tpu_torch.data.prem import prem_model, write_csv
from pysurfinv_tpu_torch.ops import kernels as tk
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig

torch.set_num_threads(1)

KEYS = ("h", "vp", "vs", "rho", "qsinv")
CLASS_KW = dict(wtype="R", Tmin=10, Tmax=30, Tstep=10)


def _close(out, ref, tol=1e-6):
    """Same NaN places, finite values within ``tol`` of ref's max."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    fin = ~np.isnan(ref)
    scale = np.abs(ref[fin]).max()
    if scale == 0.0:
        assert np.abs(out[fin]).max() == 0.0
        return
    err = np.abs(out[fin] - ref[fin]).max() / scale
    assert err <= tol, f"{err:.2e} of max > {tol:.0e}"


@pytest.fixture(scope="module")
def test1(golden):
    cols = {"H": "model_h", "Vp": "model_vp", "Vs": "model_vs",
            "Rho": "model_rho", "Qs": "model_qs"}
    return {k: np.asarray(golden[v], float) for k, v in cols.items()}


@pytest.mark.parametrize("wave,nmodes,periods", [
    ("rayleigh", 2, [10.0, 20.0, 30.0]), ("love", 1, [10.0, 30.0, 60.0])])
def test_kernel_densities_match_jax(eus_model, test1, wave, nmodes, periods):
    m = eus_model
    nz = len(np.arange(0, test1["H"].sum(), 2))
    kw = dict(wave=wave, dz=2.0, nz=nz, group=True)
    ref = jk.kernel_densities(*(jnp.asarray(m[k]) for k in KEYS),
                              jnp.asarray(periods), m["nlay"],
                              cfg=jd.SurfConfig(nmodes=nmodes), **kw)
    out = tk.kernel_densities(*(torch.tensor(m[k]) for k in KEYS),
                              torch.tensor(periods), m["nlay"],
                              cfg=SurfConfig(nmodes=nmodes), **kw)
    assert sorted(out) == sorted(ref)
    np.testing.assert_array_equal(out["valid"], np.asarray(ref["valid"]))
    np.testing.assert_array_equal(out["z"], np.asarray(ref["z"]))
    for name in ref:
        if name in ("valid", "z"):
            continue
        assert isinstance(out[name], np.ndarray), name
        assert np.isfinite(out[name]).all(), name
        _close(out[name], ref[name])


@pytest.fixture(scope="module")
def jax_classes(test1):
    """The JAX classes once, on the dict form of the model (see
    test_senskernel_pert_matches_jax for the DataFrame form)."""
    top = {k: v[:12].copy() for k, v in test1.items()}
    return {"ad": js.SensKernel(model=dict(test1), endmode=1, method="ad",
                                **CLASS_KW),
            "eigen": js.SensKernel(model=dict(test1), endmode=1,
                                   method="eigen", **CLASS_KW),
            "pert": js.SensKernelPert(model=top, **CLASS_KW)}


@pytest.mark.parametrize("form", ["DataFrame", "dict"])
@pytest.mark.parametrize("method", ["ad", "eigen"])
def test_senskernel_matches_jax(test1, jax_classes, method, form):
    model = pd.DataFrame(test1) if form == "DataFrame" else dict(test1)
    ref = jax_classes[method]
    sk = ts.SensKernel(model=model, endmode=1, method=method, device="cpu",
                       **CLASS_KW)
    assert sk.xtype == ref.xtype and list(sk.periods) == list(ref.periods)
    np.testing.assert_array_equal(sk.zdeps, ref.zdeps)
    assert sk.kernel_phv.shape == (2, 3, 3, len(ref.zdeps))
    assert np.isfinite(sk.kernel_phv).all()
    _close(sk.kernel_phv, ref.kernel_phv)
    _close(sk.kernel_grv, ref.kernel_grv)
    np.testing.assert_allclose(sk.c, ref.c, rtol=1e-10)
    np.testing.assert_allclose(sk.u, ref.u, rtol=1e-6)


@pytest.mark.parametrize("form", ["DataFrame", "dict"])
def test_senskernel_pert_matches_jax(test1, jax_classes, form):
    """The first 12 layers.  Both forms are held against the JAX class on
    the dict: on a DataFrame the JAX package's chained Vp assignment
    (``senskernel.py:249``) does not write under pandas' copy-on-write,
    so its Vp column is zero there; the port writes the column whole."""
    top = {k: v[:12].copy() for k, v in test1.items()}
    model = pd.DataFrame(top) if form == "DataFrame" else top
    ref = jax_classes["pert"]
    sk = ts.SensKernelPert(model=model, device="cpu", **CLASS_KW)
    assert sorted(sk.kernel) == sorted(ref.kernel) == ["Vp", "Vs"]
    for name in ref.kernel:
        assert np.abs(ref.kernel[name]).max() > 0, name
        _close(sk.kernel[name], ref.kernel[name])


def test_prem_table_exact(tmp_path):
    ref = jax_prem()
    out = prem_model()
    assert isinstance(out, pd.DataFrame)
    assert list(out.columns) == list(ref.columns)
    for k in ref.columns:
        np.testing.assert_array_equal(out[k].to_numpy(), ref[k].to_numpy())
    back = pd.read_csv(write_csv(str(tmp_path / "prem.csv")))
    np.testing.assert_array_equal(back.to_numpy(), ref.to_numpy())

"""Port parity of the model layer, and the port's import boundary.

* ``buildModel1D(...).seisPropLayers(refLayer=True)`` of the port against
  the JAX package's, float64, rtol 1e-10, for the bench setting
  (bench.py:36-50) and the Cascadia setting with Brownian parameters
  of the repository's verification notes; plus the padding for the
  solver and the model batch carried across from numpy.
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
                "pysurfinv_tpu_torch.models.model1d",
                "pysurfinv_tpu_torch.inversion.random",
                "pysurfinv_tpu_torch.inversion.priors",
                "pysurfinv_tpu_torch.inversion.compiled",
                "pysurfinv_tpu_torch.inversion.mcmc",
                "pysurfinv_tpu_torch.inversion.point",
                "pysurfinv_tpu_torch.parallel.grid",
                "pysurfinv_tpu_torch.ops.kernels",
                "pysurfinv_tpu_torch.ops.eigen",
                "pysurfinv_tpu_torch.senskernel",
                "pysurfinv_tpu_torch.data.prem")


def test_port_imports_no_jax():
    """The port's modules, their lazy exports (PostPoint, fast_surf, the
    analysis surface) and chip_smoke.py, which runs where JAX is absent,
    import neither JAX nor the JAX package."""
    code = ("import sys, runpy, " + ", ".join(PORT_MODULES) + "; "
            "from pysurfinv_tpu_torch import PostPoint, fast_surf; "
            "from pysurfinv_tpu_torch import SensKernel, sensitivity_kernels, "
            "eigenfunctions_regular; "
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

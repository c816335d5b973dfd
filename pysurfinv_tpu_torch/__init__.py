"""pysurfinv_tpu_torch — the PyTorch + CUDA port of ``pysurfinv_tpu``.

The batched surface-wave dispersion solve of the JAX package (one wave,
or both with ``surf_forward_joint``), the single-model solve with
overtones (also on the tree-product secular functions,
``SurfConfig(backend="xla_assoc")``), the MCMC samplers (batched and
per-chain) with ``invert_grid``'s checkpoints, lane ranges over several
devices and streamed npz writer, the experimental samplers (adaptive
Metropolis ``adaptive_point``, the tuned random walk
``tuned_rwm_point``, MALA ``mala_point`` with its likelihood gradient),
the host inversion surface, the posterior comparator, the analysis
surface (sensitivity kernels, eigenfunctions, energy integrals,
``SensKernel``) and the 3-D host analysis (``Model3D``, ``geo/``), on
PyTorch tensors, with the four secular-function kernels written by hand
in CUDA C++ for Hopper (``csrc/``).  Module paths mirror the JAX
package so each counterpart is easy to find; the JAX package is the
reference the port is tested against and is never imported here.

The device of a computation is the device of its input tensors: CUDA
tensors run the kernels, CPU tensors run the kernels' plain PyTorch
versions (see :mod:`pysurfinv_tpu_torch.ops.secular_lanes`).
"""

__version__ = "0.1.0"

from pysurfinv_tpu_torch.ops.dispersion import (  # noqa: F401
    SurfConfig,
    surf_amplitude,
    surf_ellipticity,
    surf_forward,
    surf_forward_batch,
    surf_forward_joint,
)


def __getattr__(name):
    """Lazy re-exports of the model layer, the samplers (they pull in
    scipy), the analysis surface and the 3-D host analysis."""
    _lazy = {
        "buildModel1D": "pysurfinv_tpu_torch.models.model1d",
        "Model1D": "pysurfinv_tpu_torch.models.model1d",
        "PureGird": "pysurfinv_tpu_torch.models.model1d",
        "buildSeisLayer": "pysurfinv_tpu_torch.models.layers",
        "BrownianVar": "pysurfinv_tpu_torch.models.brownian",
        "BrownianVarMC": "pysurfinv_tpu_torch.models.brownian",
        "model_batch_from_numpy": "pysurfinv_tpu_torch.convert",
        "CompiledModel": "pysurfinv_tpu_torch.inversion.compiled",
        "Point": "pysurfinv_tpu_torch.inversion.point",
        "PointCascadia": "pysurfinv_tpu_torch.inversion.point",
        "PostPoint": "pysurfinv_tpu_torch.inversion.point",
        "PostPointCascadia": "pysurfinv_tpu_torch.inversion.point",
        "fast_surf": "pysurfinv_tpu_torch.compat",
        "invert_grid": "pysurfinv_tpu_torch.parallel.grid",
        "points_devices": "pysurfinv_tpu_torch.parallel.mesh",
        "Model3D": "pysurfinv_tpu_torch.geo.model3d",
        "Model1D_Exchange": "pysurfinv_tpu_torch.geo.exchange",
        "Model3D_Exchange": "pysurfinv_tpu_torch.geo.exchange",
        "SensKernel": "pysurfinv_tpu_torch.senskernel",
        "SensKernelPert": "pysurfinv_tpu_torch.senskernel",
        "sensitivity_kernels": "pysurfinv_tpu_torch.ops.kernels",
        "eigenfunctions": "pysurfinv_tpu_torch.ops.eigen",
        "eigenfunctions_regular": "pysurfinv_tpu_torch.ops.eigen",
        "mala_point": "pysurfinv_tpu_torch.inversion.mala",
        "adaptive_point": "pysurfinv_tpu_torch.inversion.adaptive",
        "tuned_rwm_point": "pysurfinv_tpu_torch.inversion.adaptive",
        "AdaptConfig": "pysurfinv_tpu_torch.inversion.adaptive",
    }
    if name in _lazy:
        import importlib

        return getattr(importlib.import_module(_lazy[name]), name)
    raise AttributeError(
        f"module 'pysurfinv_tpu_torch' has no attribute {name!r}")

"""The port's sensitivity kernels against its own forward and the TEST1
goldens, float64 on the CPU (no JAX: the conftest-free helpers of
tests/torch_helpers.py give the model and the goldens).

As tests/test_kernels.py does for the JAX package: the AD kernels of
``sensitivity_kernels`` (nbisect 30) against central finite differences
of the port's ``surf_forward`` at layers 5/17/30/50, T = 10, 30, 60 s,
within 2e-5 of scale for phase and 3e-3 for group; u against the
solve's u (F_T taken at fixed attenuated + flattened material, not
through the attenuation rescale in T) and the TEST1 golden to 1e-4;
apparent Q against the TEST1 ``.att`` golden to 2e-2.
"""

import numpy as np
import pytest
import torch

from torch_helpers import GOLDEN, load_eus_model

from pysurfinv_tpu_torch.ops import kernels as tk
from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig, _secular_fn,
                                                surf_forward)
from pysurfinv_tpu_torch.ops.flatten import effective_thickness
from pysurfinv_tpu_torch.ops.secular import effective_halfspace

torch.set_num_threads(1)

KEYS = ("h", "vp", "vs", "rho", "qsinv")
PERIODS = np.array([10.0, 30.0, 60.0])
GOLDEN_ROWS = [0, 2, 5]          # of the golden periods 10, 20, ..., 100
# the FD reference needs converged roots (tests/test_kernels.py:27-33)
FD_CFG = dict(nmodes=1, nbisect=30)


@pytest.fixture(scope="module")
def eus():
    return load_eus_model()


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


def _port(m, wave, **cfg):
    return tk.sensitivity_kernels(
        *(torch.tensor(np.asarray(m[k], np.float64)) for k in KEYS),
        torch.tensor(PERIODS), m["nlay"], wave=wave, cfg=SurfConfig(**cfg),
        group=True)


@pytest.fixture(scope="module", params=["rayleigh", "love"])
def port_fd(request, eus):
    """The port's nbisect-30 kernels and central finite differences of
    its own surf_forward at layers 5/17/30/50 (dc and du of each)."""
    wave, m = request.param, eus
    res = _port(m, wave, **FD_CFG)
    base = {k: np.array(m[k], np.float64) for k in KEYS}
    fd = {}
    for which in ("vs", "vp", "rho"):
        if wave == "love" and which == "vp":
            continue
        dc, du = [], []
        for i in (5, 17, 30, 50):
            out = []
            for sgn in (+1, -1):
                pert = {k: v.copy() for k, v in base.items()}
                step = 1e-3 * pert[which][i]
                pert[which][i] += sgn * step
                c, u, ok = surf_forward(
                    *(torch.tensor(pert[k]) for k in KEYS),
                    torch.tensor(PERIODS), m["nlay"], wave=wave,
                    cfg=SurfConfig(**FD_CFG))
                assert ok.all()
                out.append((c[:, 0].numpy(), u[:, 0].numpy(), step))
            (cp, up, s), (cm, um, _) = out
            dc.append((cp - cm) / (2 * s))
            du.append((up - um) / (2 * s))
        fd[which] = (np.array(dc).T, np.array(du).T)
    return wave, res, fd


@pytest.mark.parametrize("which", ["vs", "vp", "rho"])
def test_phase_kernels_vs_own_fd(port_fd, which):
    wave, res, fd = port_fd
    if which not in fd:
        assert np.abs(res.dc_dvp.numpy()).max() == 0.0  # Love: no Vp
        return
    ad = getattr(res, "dc_d" + which).numpy()[:, [5, 17, 30, 50]]
    ref = fd[which][0]
    assert np.abs(ad - ref).max() / (np.abs(ref).max() + 1e-12) < 2e-5


@pytest.mark.parametrize("which", ["vs", "rho"])
def test_group_kernels_vs_own_fd(port_fd, which):
    """As tests/test_kernels.py: the FD group velocity jumps by ~1e-4
    where the +- runs freeze different halfspace truncations."""
    wave, res, fd = port_fd
    ad = getattr(res, "du_d" + which).numpy()[:, [5, 17, 30, 50]]
    ref = fd[which][1]
    assert np.abs(ad - ref).max() / (np.abs(ref).max() + 1e-12) < 3e-3


def _u_through_attenuation(m, wave, c):
    """The wrong group velocity: F_T differentiated through the period
    dependence of the attenuated model as well."""
    cfg = SurfConfig()
    h, vp, vs, rho, qsi = (torch.tensor(np.asarray(m[k], np.float64))
                           for k in KEYS)
    kind = 1 if wave == "love" else 2
    h_eff = effective_thickness(h, m["nlay"])
    t = torch.tensor(PERIODS, requires_grad=True)
    cc = torch.tensor(c, requires_grad=True)
    mdl = tk._flat_model(t, vp, vs, rho, h_eff, qsi, m["nlay"], kind, cfg)
    with torch.no_grad():
        mm = effective_halfspace(cc, t, mdl[1], mdl[3], m["nlay"], cfg.fact)
    f_c, f_t = torch.autograd.grad(_secular_fn(wave)(cc, t, mdl, mm).sum(),
                                   (cc, t))
    return (cc / (1.0 - (t / cc) * f_t / f_c)).detach().numpy()


def test_group_velocity_at_fixed_material(port_fd, eus, gold):
    """u from the kernels' W equals the solve's u (F_T at fixed attenuated
    + flattened material) and the TEST1 golden to 1e-4; differentiating
    through the attenuation rescale in T would move u far past that."""
    wave, res, _ = port_fd
    m = eus
    _, u_solve, _ = surf_forward(
        *(torch.tensor(np.asarray(m[k], np.float64)) for k in KEYS),
        torch.tensor(PERIODS), m["nlay"], wave=wave,
        cfg=SurfConfig(**FD_CFG))
    u = res.u.numpy()
    np.testing.assert_allclose(u, u_solve[:, 0].numpy(), rtol=1e-8)
    wt = "R" if wave == "rayleigh" else "L"
    ref = gold[f"grv_{wt}_0"][GOLDEN_ROWS, 1]
    assert (np.abs(u - ref) / ref).max() < 1e-4
    wrong = _u_through_attenuation(m, wave, res.c.numpy())
    assert (np.abs(wrong - ref) / ref).max() > 1e-3


def test_apparent_q_golden(port_fd, gold):
    """Apparent Q vs the TEST1 .att goldens (tests/test_kernels.py)."""
    wave, res, _ = port_fd
    wt = "R" if wave == "rayleigh" else "L"
    ref = gold[f"att_{wt}_0"][GOLDEN_ROWS, 1]
    assert (np.abs(res.q_app.numpy() - ref) / ref).max() < 2e-2

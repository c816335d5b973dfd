"""Port parity of ``surf_forward_batch``'s warm-start and rescue paths.

float32, the port on the CPU against the JAX fast path in interpret
mode, same numpy inputs, bounds of tests/test_pallas_secular.py:192-194
(see tests/test_torch_dispersion.py):

  * ``c_warm``: the fused seeded sweep on a proposal batch (the roots
    of a batch handed to the same batch with a 0.2% Vs/Vp step, as an
    MCMC sampler does), with one model's seeds unknown (0) so the
    cold-chain fill runs too.  The step matters: seeded with a model's
    own roots, the sampler window (backoff 12 dc, coarse 8 dc) starts
    Newton exactly on the root, where sign(F) is float32 noise;
  * the MCMC sampler's settings (``newton_sep=3`` separated Newton,
    parallel/grid.py:271-280) from ``c_warm``;
  * the sparse-period rescue pass, on the inputs of
    tests/test_dispersion_golden.py:141-156.
"""

import numpy as np
import pytest
import torch

from test_torch_dispersion import PERIODS, assert_same_solution, solve_both
from torch_helpers import eus_batch

from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward_batch

torch.set_num_threads(1)

SAMPLER = dict(compute_group=False, nscan=32, warm_backoff=12, nbisect=11,
               coarse=8, newton_sep=3, coarse_first=8)


@pytest.fixture(scope="module")
def batch(eus_model):
    return eus_batch(eus_model)


@pytest.fixture(scope="module")
def proposal(batch):
    """The batch after one 0.2% Vs/Vp step."""
    h, vp, vs, rho, qsi, nlay = batch
    step = (1.0 + 0.002 * np.random.default_rng(11).standard_normal(
        vs.shape)).astype(np.float32)
    return h, vp * step, vs * step, rho, qsi, nlay


@pytest.fixture(scope="module")
def c_warm(batch):
    """The batch's roots (the port's cold solve); model 1's unknown."""
    c, _, ok = surf_forward_batch(*map(torch.tensor, batch[:5]),
                                  torch.tensor(PERIODS),
                                  torch.tensor(batch[5]), cfg=SurfConfig())
    assert ok.all()
    cw = c[:, :, 0].numpy().copy()
    cw[1] = 0.0
    return cw


@pytest.mark.parametrize("kw", [{}, SAMPLER], ids=["default", "sampler"])
def test_warm_start_matches_jax_f32(proposal, c_warm, kw):
    jax_out, port_out = solve_both(proposal, PERIODS, "rayleigh",
                                   c_warm=c_warm, **kw)
    assert_same_solution(jax_out, port_out)


def test_sparse_period_rescue_matches_jax_f32(eus_model):
    m = eus_model
    B = 3
    tile = lambda x: np.tile(np.asarray(x, np.float32)[None], (B, 1))  # noqa
    batch = tuple(tile(m[k]) for k in ("h", "vp", "vs", "rho", "qsinv")) \
        + (np.full((B,), m["nlay"], np.int32),)
    sparse = np.array([10.0, 30.0, 60.0], np.float32)
    jax_out, port_out = solve_both(batch, sparse, "rayleigh", nmodes=1,
                                   compute_group=False)
    assert_same_solution(jax_out, port_out)

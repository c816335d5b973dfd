"""Port parity of the fused refinement ``refine_lanes`` and the solver
options that route through it (``SurfConfig.nnewton``, ``fuse_illinois``).

float32, as on the card: the port on the CPU (the kernel's plain
version) against the JAX package's ``refine_lanes`` Pallas kernel in
interpret mode, on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_helpers import eus_batch, root_brackets, with_water_top

from pysurfinv_tpu.ops.dispersion import SurfConfig as JaxConfig
from pysurfinv_tpu.ops.dispersion import surf_forward_batch as jax_solve
from pysurfinv_tpu.ops.pallas_secular import refine_lanes as jax_refine
from pysurfinv_tpu_torch.convert import model_batch_from_numpy
from pysurfinv_tpu_torch.ops import secular_lanes as tsl
from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward_batch
from pysurfinv_tpu_torch.ops.flatten import flatten_factors

torch.set_num_threads(1)

PERIODS18 = np.array([10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40,
                      50, 60, 70, 80], np.float32)
PERIODS = np.array([10.0, 20.0, 40.0, 80.0], np.float32)


@pytest.fixture(scope="module")
def lanes(eus_model):
    """Per wave: (K=18, B=4) brackets around each lane's root on the eus
    batch plus a water-top model, and the (L, B) model both packages
    take."""
    h, vp, vs, rho, qsi, nlay = with_water_top(eus_batch(eus_model))
    out = {}
    for wave in ("rayleigh", "love"):
        fac = flatten_factors(torch.tensor(h), torch.tensor(nlay),
                              1 if wave == "love" else 2)
        model = [torch.tensor(x).T.contiguous() for x in (vp, vs, rho, qsi)]
        model += [x.T.contiguous() for x in fac]
        t = torch.tensor(PERIODS18)[:, None].expand(18, h.shape[0])
        t = t.contiguous()
        nl = torch.tensor(nlay)
        lo, hi, mm = root_brackets(t, t, model, nl, wave)
        out[wave] = (lo, hi, t, mm, model, nl)
    return out


def _refine_both(lanes, wave, n_newton, dtype):
    """(port, JAX) refine_lanes outputs on the same inputs, in dtype."""
    lo, hi, t, mm, model, nl = lanes[wave]
    cast = lambda x: x.to(dtype) if x.is_floating_point() else x  # noqa
    args = [cast(x) for x in (lo, hi, t, mm, *model, nl)]
    kw = dict(wave=wave, n_ill=6, n_newton=n_newton,
              compute_group=n_newton > 0)
    rj, uj = jax_refine(*(jnp.asarray(x.numpy()) for x in args),
                        interpret=True, **kw)
    rt, ut = tsl.refine_lanes_plain(*args, **kw)
    assert rt.dtype == dtype
    return (rt.double().numpy(), ut.double().numpy(),
            np.asarray(rj, np.float64), np.asarray(uj, np.float64))


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
@pytest.mark.parametrize("n_newton", [0, 2])
def test_refine_plain_matches_jax_kernel_f64(lanes, wave, n_newton):
    """The transcription: in float64, where F's noise no longer decides
    the Illinois and Newton branches, roots agree to 1e-6 km/s and group
    velocities to 1e-5 relative."""
    rt, ut, rj, uj = _refine_both(lanes, wave, n_newton, torch.float64)
    assert np.abs(rt - rj).max() <= 1e-6
    if n_newton:
        assert (np.abs(ut - uj) <= 1e-5 * np.abs(uj)).all()
    else:
        assert (ut == 0).all() and (uj == 0).all()


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
@pytest.mark.parametrize("n_newton", [0, 2])
def test_refine_plain_matches_jax_kernel(lanes, wave, n_newton):
    """(a) float32, the kernels' type.  At a root F is float32 noise,
    and XLA's and ATen's expf/sinf round differently, so on a few lanes
    the two take another Illinois branch or the Newton midpoint fallback
    and end up to ~5e-4 km/s apart, each as far from the float64 root
    as the other; and u inherits the float32 F_T/F_c tail (PERF.md).
    So each is held to the float64 refinement of the same brackets: the
    port's root error at the median, q90 and max no more than 1e-5 km/s
    above JAX's, and its relative u error at the median and q90 no more
    than 1e-4 above JAX's."""
    lo, hi, t, mm, model, nl = lanes[wave]
    Fl = tsl.secular_lanes_frozen_plain(lo, t, mm, *model, nl, wave=wave)
    Fh = tsl.secular_lanes_frozen_plain(hi, t, mm, *model, nl, wave=wave)
    assert bool((torch.sign(Fl) != torch.sign(Fh)).all())  # real brackets
    rt, ut, rj, uj = _refine_both(lanes, wave, n_newton, torch.float32)
    r64, u64 = (x.numpy() for x in tsl.refine_lanes_plain(
        lo.double(), hi.double(), t.double(), mm,
        *(m.double() for m in model), nl, wave=wave, n_ill=30, n_newton=3))
    assert ((rt >= lo.numpy()) & (rt <= hi.numpy())).all()
    q = (0.5, 0.9, 1.0)
    et = np.quantile(np.abs(rt - r64), q)
    ej = np.quantile(np.abs(rj - r64), q)
    assert (et <= ej + 1e-5).all()
    if n_newton:
        rel = lambda u: np.quantile(np.abs(u - u64) / np.abs(u64),  # noqa
                                    (0.5, 0.9))
        assert (rel(ut) <= rel(uj) + 1e-4).all()
    else:
        assert (ut == 0).all() and (uj == 0).all()


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
@pytest.mark.parametrize("kw", [dict(nnewton=2),
                                dict(fuse_illinois=True, coarse=4,
                                     nbisect=11)],
                         ids=["nnewton2", "fuse_illinois"])
def test_solve_through_refine_matches_jax(eus_model, wave, kw):
    """(b) surf_forward_batch with the refinement in one refine_lanes
    launch, against the JAX fast path in interpret mode
    (tests/test_pallas_secular.py:173-245): identical ok masks,
    |dc| < 5e-5 km/s, |du| < 5e-4 km/s."""
    h, vp, vs, rho, qsi, nlay = eus_batch(eus_model)
    cj, uj, okj = jax_solve(
        *map(jnp.asarray, (h, vp, vs, rho, qsi)), jnp.asarray(PERIODS),
        jnp.asarray(nlay), wave=wave,
        cfg=JaxConfig(nmodes=1, backend="pallas_interpret", **kw))
    *model, nl = model_batch_from_numpy(h, vp, vs, rho, qsi, nlay,
                                        device="cpu")
    tsl.reset_launch_counts()
    ct, ut, okt = surf_forward_batch(*model, torch.tensor(PERIODS), nl,
                                     wave=wave, cfg=SurfConfig(**kw))
    assert tsl.refine_lanes.launches == 0  # CPU tensors: plain version
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.all()
    assert np.abs(ct.numpy() - np.asarray(cj)).max() < 5e-5
    assert np.abs(ut.numpy() - np.asarray(uj)).max() < 5e-4


def test_fused_illinois_equals_separate_launches(eus_model):
    """fuse_illinois runs the same Illinois iterations as the separate
    frozen launches in one refine_lanes call: roots and group velocities
    are bitwise those of the unfused path (fhandoff off, as in
    tests/test_pallas_secular.py:222-254)."""
    batch = eus_batch(eus_model)
    *model, nl = model_batch_from_numpy(*batch[:5], batch[5], device="cpu")
    per = torch.tensor(PERIODS)
    outs = [surf_forward_batch(*model, per, nl, cfg=SurfConfig(
        coarse=4, nbisect=11, fuse_illinois=fuse)) for fuse in (False, True)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)

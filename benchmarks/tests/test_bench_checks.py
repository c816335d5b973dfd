"""``correct`` has to come out false: the control (the reference, or the
program's own lower-precision path, in the program's place) and the
timed path broken underneath, each at a tiny size on the CPU, the run
driven as on the card but for the look for a chip.

Faults a cell can have, each planted in the program:
* a step that returns its state unchanged (the sampler's segment hands
  back the carry it got);
* half of the batch left out, the mean of the rest in its place (the
  solve, or the prior, of every other lane);
* an answer altered where it is produced (a phase velocity, a misfit, a
  proposal);
* the exchange between chips left out: no cell runs on more than one
  chip, so there is none to leave out.
"""

from __future__ import annotations

import pytest
import torch

from conftest import TINY_TRAFFIC, make_tiny, tiny_cell

import control as C
import run as R


def _run(tiny, name, seconds=0.1):
    res, checks, _ = R.run_cell(tiny_cell(tiny, name), 2 ** 31 + 99, seconds,
                                False, "cpu", R.process_start())
    return res


@pytest.mark.parametrize("name", ["survey.ocean.posterior",
                                  "survey.ocean.priori",
                                  "forward.ocean.batch"])
def test_control_is_not_correct(tiny, name):
    r = C.readings(tiny_cell(tiny, name), 2 ** 32 + 5, 0.1, "cpu")
    lim = r["limits"]
    assert all(v <= lim[k] for k, v in r["program"].items()), r
    assert any(v > lim[k] for k, v in r["control"].items()), r


def _stale_state(monkeypatch):
    from pysurfinv_tpu_torch.inversion import mcmc
    real = mcmc.make_segmented_sampler

    def broken(*a, **kw):
        init_fn, seg_fn = real(*a, **kw)

        def seg(carry, *args):
            _, rows = seg_fn(carry, *args)
            return carry, rows
        return init_fn, seg

    monkeypatch.setattr(mcmc, "make_segmented_sampler", broken)


def _half_the_solves(monkeypatch):
    from pysurfinv_tpu_torch.ops import dispersion
    real = dispersion.surf_forward_batch

    def broken(h, vp, vs, rho, qsinv, periods, nlay, **kw):
        n = h.shape[0] // 2 or 1
        cut = lambda x: x[:n] if torch.is_tensor(x) and x.dim() and \
            x.shape[0] == h.shape[0] else x  # noqa: E731
        kw = {k: cut(v) for k, v in kw.items()}
        c, u, ok = real(*(cut(x) for x in (h, vp, vs, rho, qsinv, periods,
                                            nlay)), **kw)
        fill = lambda x: torch.cat([x, x.float().mean(0, keepdim=True).to(
            x.dtype).expand(h.shape[0] - n, *x.shape[1:])])  # noqa: E731
        return fill(c), fill(u), fill(ok.float()) > 0.5

    monkeypatch.setattr(dispersion, "surf_forward_batch", broken)


def _half_the_prior(monkeypatch):
    from pysurfinv_tpu_torch.inversion.compiled import CompiledModel
    real = CompiledModel.isgood

    def broken(self, thetas, psis=None):
        ok = real(self, thetas, psis)
        ok[1::2] = True
        return ok

    monkeypatch.setattr(CompiledModel, "isgood", broken)


def _altered_phase(monkeypatch):
    from pysurfinv_tpu_torch.ops import dispersion
    real = dispersion.surf_forward_batch

    def broken(*a, **kw):
        c, u, ok = real(*a, **kw)
        c = c.clone()
        c[:, 3] += 0.01
        return c, u, ok

    monkeypatch.setattr(dispersion, "surf_forward_batch", broken)


def _shifted_group(monkeypatch):
    """A group velocity off by 1.5 km/s on one lane in 128 (model x
    period): fewer than the 99th percentile sees."""
    from pysurfinv_tpu_torch.ops import dispersion
    real = dispersion.surf_forward_batch

    def broken(*a, **kw):
        c, u, ok = real(*a, **kw)
        u = u.clone()
        lane = torch.arange(u[..., 0].numel(), device=u.device)
        u[..., 0][(lane % 128 == 0).reshape(u.shape[:-1])] += 1.5
        return c, u, ok

    monkeypatch.setattr(dispersion, "surf_forward_batch", broken)


def _altered_misfit(monkeypatch):
    from pysurfinv_tpu_torch.inversion.point import PointCascadia
    real = PointCascadia._misfit_from_c

    def broken(*a, **kw):
        m, chi, L = real(*a, **kw)
        return m * 1.5, chi, L

    monkeypatch.setattr(PointCascadia, "_misfit_from_c",
                        staticmethod(broken))


def _altered_proposal(monkeypatch):
    from pysurfinv_tpu_torch.inversion import mcmc
    real = mcmc._propose_batched

    def broken(keys, thetas, spec, *a, **kw):
        cand, found = real(keys, thetas, spec, *a, **kw)
        return cand + 1e-6 * spec.step, found

    monkeypatch.setattr(mcmc, "_propose_batched", broken)


FAULTS = [
    ("survey.ocean.posterior", _stale_state),
    ("survey.ocean.posterior", _half_the_solves),
    ("survey.ocean.posterior", _altered_misfit),
    ("survey.ocean.priori", _stale_state),
    ("survey.ocean.priori", _half_the_prior),
    ("survey.ocean.priori", _altered_proposal),
    ("forward.ocean.batch", _half_the_solves),
    ("forward.ocean.batch", _altered_phase),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    fault(monkeypatch)
    res = _run(tiny, name, seconds=3.0 if "survey" in name else 0.1)
    assert res["correct"] is False, res["checks"]


def test_a_group_velocity_off_on_a_few_lanes_is_not_correct(tmp_path,
                                                            monkeypatch):
    """The count of lanes off catches what the 99th percentile cannot:
    96 judged curves, of which about one lane in 72 is off."""
    b = make_tiny(str(tmp_path), dict(TINY_TRAFFIC, forward_batch=dict(
        TINY_TRAFFIC["forward_batch"], check_curves=96)))
    _shifted_group(monkeypatch)
    res, _, _ = R.run_cell(tiny_cell(b, "forward.ocean.batch"), 2 ** 31 + 99,
                           0.1, False, "cpu", R.process_start())
    off = res["checks"]["group_off_lanes"]
    assert off["value"] > off["limit"], res["checks"]


def test_the_unbroken_runs_are_correct(tiny):
    for name in ("survey.ocean.posterior", "survey.ocean.priori"):
        res = _run(tiny, name, seconds=3.0)
        assert res["correct"] is True, res["checks"]

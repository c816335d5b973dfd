"""Judge of the ``survey`` entry: a sample of the window's rows, drawn
from the seed, and a sample of the chains' start rows, each replayed by
the plain reference from the chain state the rows record.

Numbers compared (each against the traffic's ``limits``):

* ``theta_gap``: the largest gap between a row's proposal and the
  reference's first prior-accepted candidate from the same key and
  state, in units of the parameter's proposal step (the proposal draws,
  the profile build and the prior of every sampled row);
* ``misfit_gap`` (posterior only): the largest relative gap between a
  row's misfit and the reference's misfit of the same proposal (the
  profile build, the float64 solve at every observed period and the
  band-split misfit); 1e9 where exactly one side found no root;
* ``accept_gap``: rows whose recorded acceptance differs from the
  Metropolis rule applied to the rows' own misfits with the reference's
  uniform draw (prior mode: rows not recorded as accepted).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import cascadia as RC
from reference import chains as CH
from reference import secular as SE
from reference import threefry as TF

FAIL_GAP = 1e9


def _sample(out, traffic, seed):
    """(generation, lane, row) of the judged rows: ``check_rows`` drawn
    uniformly from the window's rows and ``check_starts`` start rows of
    the first chain set."""
    rng = np.random.default_rng([seed, 3])
    n = out["n"]
    spans = [(g, s0, s1) for g, s0, s1 in out["window"]]
    sizes = np.array([(s1 - s0) * n for _, s0, s1 in spans])
    flat = rng.choice(int(sizes.sum()),
                      size=min(int(traffic["check_rows"]), int(sizes.sum())),
                      replace=False)
    cum = np.cumsum(sizes)
    picks = []
    for f in np.sort(flat):
        k = int(np.searchsorted(cum, f, side="right"))
        g, s0, s1 = spans[k]
        f = f - (cum[k] - sizes[k])
        picks.append((g, int(f % n), s0 + int(f // n)))
    for j in rng.choice(n, size=min(int(traffic["check_starts"]), n),
                        replace=False):
        picks.append((0, int(j), 0))
    return picks


class Rows:
    """The judged rows and their chain states, read off the tracks."""

    def __init__(self, out, picks, priori):
        self.picks = picks
        th1, m1, acc, lc, ths, ms = [], [], [], [], [], []
        for g, j, r in picks:
            off, tracks = out["generations"][g]
            rows = tracks[j]
            s = r - 1
            if not priori:
                while s > 0 and rows[s, 2] != 1.0:
                    s -= 1
            s = max(s, 0)
            th1.append(rows[r, 3:])
            m1.append(rows[r, 0])
            lc.append(rows[r, 1])
            acc.append(rows[r, 2])
            ths.append(rows[s, 3:])
            ms.append(rows[s, 0])
        self.theta1, self.m1, self.L1, self.acc = map(np.array,
                                                      (th1, m1, lc, acc))
        self.theta_s, self.m_s = np.array(ths), np.array(ms)
        self.row = np.array([r for _, _, r in picks])
        self.lane = np.array([out["generations"][g][0] + j
                              for g, j, _ in picks])
        self.point = np.array([j // out["nch"] for _, j, _ in picks])
        self.first_chain = np.array([j % out["nch"] == 0 for _, j, _ in picks])


def _lanes(cell, out, rows, dtype, device):
    cfg = cell.config
    pts = [RC.parse_point(cfg["setting"], loc) for loc in out["locals"]]
    st = RC.Structure(pts[0])
    o = cfg["observations"]
    S = len(rows.picks)
    obs = (np.tile(o["periods"], (S, 1)), np.tile(o["vels"], (S, 1)),
           np.tile(o["uncers"], (S, 1)), np.ones((S, len(o["periods"])), bool))
    return CH.Lanes(st, [pts[p] for p in rows.point], obs, dtype, device)


def _reference_misfit(lanes, thetas, eval_dtype):
    """(misfit, chi) of the models ``thetas`` (S, P) of the lanes."""
    idx = torch.arange(thetas.shape[0], device=thetas.device)
    h, vp, vs, rho, qsi, nlay = RC.lane_profile(lanes.st,
                                                lanes.params(thetas, idx))
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    c, _, ok = SE.solve(*map(f64, (h, vp, vs, rho, qsi)), nlay,
                        f64(lanes.periods), dtype=eval_dtype)
    c = torch.where(ok, c, torch.zeros_like(c)).to(lanes.dtype)
    return RC.misfit(c, lanes.obs_c, lanes.uncer, lanes.periods, lanes.obs_m)


def _proposals(lanes, rows, seed, chain_len, device):
    """The reference's proposal of each judged row (its start model for
    rows 0) and whether the prior accepted one."""
    S = len(rows.picks)
    idx = torch.arange(S, device=device)
    keys = CH.lane_keys(seed, torch.as_tensor(rows.lane, device=device),
                        device)
    state = torch.as_tensor(rows.theta_s, dtype=lanes.dtype, device=device)
    r = torch.as_tensor(rows.row, device=device)
    cand, found = CH.propose(lanes, TF.fold_in(keys, 2 * r), state, idx)
    at0 = r == 0
    if bool(at0.any()):
        st0 = CH.start(lanes, keys, idx,
                       torch.as_tensor(rows.first_chain, device=device),
                       chain_len)
        cand = torch.where(at0[:, None], st0, cand)
        found = found | at0
    return cand, found, keys


def judge(cell, out, seed, device, control=False):
    """[(name, value, limit)] of the cell; with ``control`` the rows are
    first remade by the reference in the precision below the
    configuration's (float32 draws, profile and prior; bfloat16 solve)
    from the same chain states, and those are judged instead."""
    tr = cell.traffic
    priori = bool(tr["priori"])
    rows = Rows(out, _sample(out, tr, seed), priori)
    lanes = _lanes(cell, out, rows, torch.float64, device)
    cand, found, keys = _proposals(lanes, rows, seed, out["chain_len"], device)
    theta1 = torch.as_tensor(rows.theta1, device=device)
    m1 = torch.as_tensor(rows.m1, device=device)
    acc = torch.as_tensor(rows.acc, device=device)
    m_s = torch.as_tensor(rows.m_s, device=device)
    r = torch.as_tensor(rows.row, device=device)
    if control:
        lo = _lanes(cell, out, rows, torch.float32, device)
        theta1, found_c, _ = _proposals(lo, rows, seed, out["chain_len"],
                                        device)
        theta1 = theta1.to(torch.float64)
        if not priori:
            m1 = _reference_misfit(lo, theta1.to(torch.float32),
                                   torch.bfloat16)[0].to(torch.float64)
            u = CH.accept_uniform(keys, r, torch.float32).to(torch.float64)
            n_obs = float(lanes.obs_m.sum(-1)[0])
            acc = CH.metropolis(CH.chi_from_misfit(m1, n_obs),
                                CH.chi_from_misfit(m_s, n_obs), u, found_c,
                                m1) | (r == 0)
            acc = acc.to(torch.float64)
    step = lanes.step
    checks = [("theta_gap", float(((theta1 - cand).abs() / step).max()))]
    if priori:
        L1 = torch.as_tensor(rows.L1, device=device)
        bad = (acc != 1.0) | (L1 != (r == 0).to(L1.dtype))
        checks.append(("accept_gap", int(bad.sum())))
    else:
        m_ref, _ = _reference_misfit(lanes, theta1, torch.float64)
        fail_p, fail_r = m1 >= CH.MISFIT_FAIL, m_ref >= CH.MISFIT_FAIL
        gap = (m1 - m_ref).abs() / m_ref
        gap = torch.where(fail_p | fail_r, torch.zeros_like(gap), gap)
        gap = torch.where(fail_p != fail_r, torch.full_like(gap, FAIL_GAP),
                          gap)
        checks.append(("misfit_gap", float(gap.max())))
        n_obs = float(lanes.obs_m.sum(-1)[0])
        u = CH.accept_uniform(keys, r, torch.float64)
        want = CH.metropolis(CH.chi_from_misfit(m1, n_obs),
                             CH.chi_from_misfit(m_s, n_obs), u, found, m1)
        want = want | (r == 0)
        checks.append(("accept_gap", int((want != (acc == 1.0)).sum())))
    lim = tr["limits"]
    return [(n, v, lim[n]) for n, v in checks]

"""Plain reference of one Metropolis step of the grid sampler, replayed
row by row from the recorded chain state.

Reference semantics (pySurfInv point.py:32-125, models.py:192-219): a
proposal perturbs every stochastic parameter by a Gaussian step kept in
bounds (a truncated normal), redrawn until the prior accepts the model,
for 100 rounds, then resets to uniform draws for 500 more; the proposal
is accepted by the Metropolis rule on the soft-capped chi^2.  Every draw
is keyed by (lane key, row): row r proposes from the key fold_in(lane,
2r) and accepts with the uniform of fold_in(lane, 2r + 1).  Row 0 of a
chain set evaluates the start model: the point's initial model on its
first chain, a prior-accepted uniform draw (keys fold_in(lane, 2 chainL)
and fold_in(lane, 2 chainL + 1), one perturbation round) on the others.

``dtype`` is the precision of the draws, the profile build and the prior
(float64 as the configuration states; float32 for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import cascadia as RC
from reference import threefry as TF

N_PERTURB, N_RESET = 100, 500
MISFIT_FAIL = 88888.0


def lane_keys(seed, lanes, device):
    """The keys of global lanes ``lanes`` (int64 tensor)."""
    return TF.fold_in(TF.key(seed, device), lanes)


class Lanes:
    """The stochastic specs, fixed parameters and observations of a set
    of lanes (one parsed point each), as device tensors."""

    def __init__(self, st, pts, obs, dtype=torch.float64, device="cpu"):
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype,  # noqa
                                      device=device)
        self.st, self.dtype = st, dtype
        self.vmin = t([p["vmin"] for p in pts])
        self.vmax = t([p["vmax"] for p in pts])
        self.step = t([p["step"] for p in pts])
        self.theta0 = t([p["theta0"] for p in pts])
        proto = RC.lane_params(st, pts, self.theta0, dtype)
        self.fixed = {k: v for k, v in proto.items() if k not in st.names}
        T, c, u, m = obs
        self.periods, self.obs_c, self.uncer = t(T), t(c), t(u)
        self.obs_m = torch.as_tensor(m, device=device)

    def params(self, thetas, idx):
        """Lane parameters of candidate models ``thetas`` (N, P) of the
        lanes ``idx`` (N,)."""
        p = {k: v[idx] for k, v in self.fixed.items()}
        for i, name in enumerate(self.st.names):
            p[name] = thetas[:, i:i + 1]
        return p

    def prior(self, thetas, idx):
        return RC.prior(self.st, self.params(thetas, idx))


def _draw(lanes, r, k1, theta, idx):
    """Round r's candidate of each lane from its key k1 (N, 2)."""
    lo, hi, step = lanes.vmin[idx], lanes.vmax[idx], lanes.step[idx]
    if r < lanes.n_perturb:
        z = TF.truncated_normal(k1, (lo - theta) / step, (hi - theta) / step,
                                lanes.dtype)
        return theta + z * step
    return lo + TF.uniform(k1, lo.shape[-1], lanes.dtype) * (hi - lo)


def propose(lanes, keys, theta, idx, n_perturb=N_PERTURB, width=16):
    """The first prior-accepted candidate of each lane (``keys`` (N, 2),
    states ``theta`` (N, P) of lanes ``idx``), drawing in order; a lane
    that exhausts the rounds keeps its state.  Returns (cand, found)."""
    lanes.n_perturb = n_perturb
    n = theta.shape[0]
    cand, found = theta.clone(), torch.zeros(n, dtype=torch.bool,
                                             device=theta.device)
    k = keys
    live = torch.arange(n, device=theta.device)
    r = 0
    while r < n_perturb + N_RESET and live.numel():
        cands = []
        for j in range(min(width, n_perturb + N_RESET - r)):
            ks = TF.split(k)
            k, k1 = ks[:, 0], ks[:, 1]
            c = _draw(lanes, r + j, k1, theta[live], idx[live])
            cands.append(c)
        C = torch.stack(cands)                              # (W, n, P)
        W = C.shape[0]
        good = lanes.prior(C.reshape(W * live.numel(), -1),
                           idx[live].repeat(W)).reshape(W, -1)
        has = good.any(0)
        first = torch.argmax(good.to(torch.int8), dim=0)
        pick = C[first, torch.arange(live.numel(), device=C.device)]
        cand[live[has]] = pick[has]
        found[live[has]] = True
        k = k[~has]
        live = live[~has]
        r += W
    return cand, found


def start(lanes, keys, idx, use_init, chain_len):
    """Row 0's model of each lane."""
    k1 = TF.fold_in(keys, 2 * chain_len)
    k2 = TF.fold_in(keys, 2 * chain_len + 1)
    lo, hi = lanes.vmin[idx], lanes.vmax[idx]
    u = lo + TF.uniform(k2, lo.shape[-1], lanes.dtype) * (hi - lo)
    th, _ = propose(lanes, k1, u, idx, n_perturb=1)
    return torch.where(use_init[:, None], lanes.theta0[idx], th)


def accept_uniform(keys, row, dtype):
    return TF.uniform(TF.fold_in(keys, 2 * row + 1), 0, dtype)


def chi_from_misfit(m, n_obs):
    """The soft-capped chi^2 that the misfit m = sqrt(chi^2 / N) came
    from; the failure value stays itself."""
    chi = m * m * n_obs
    chi = torch.where(chi < 50, chi, torch.sqrt(chi * 50.0))
    return torch.where(m >= MISFIT_FAIL, torch.full_like(m, MISFIT_FAIL), chi)


def metropolis(chi1, chi0, u, found, m1):
    return (((chi1 < chi0) | (u > 1.0 - torch.exp(-(chi1 - chi0) / 2)))
            & found & (m1 < MISFIT_FAIL))

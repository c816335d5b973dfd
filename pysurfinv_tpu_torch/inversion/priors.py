"""Prior (``isgood``) building blocks, host and lane-batched versions.

Counterpart of the JAX package's ``inversion/priors.py``.  The reference
expresses priors as Python checks over rebuilt grids (models.py:294-677),
including scipy local-extrema and continuous-wavelet oscillation tests.
Each constraint exists twice with one set of semantics:

  * numpy host versions (used by the object API's ``isgood``);
  * tensor versions over a leading lane axis ``(N, n)`` (used by the
    batched sampler, where every constraint is a boolean per lane
    instead of control flow).  The JAX package's device versions test
    "adjacent flagged entries" with an (n, n) pair matrix, a layout for
    the TPU; here each flagged entry gathers its next flagged neighbour,
    which decides the same pairs.

scipy removed ``signal.cwt``/``signal.ricker`` in 1.12, so the Ricker
CWT is implemented directly (same definition scipy used).
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# host (numpy) versions
# ---------------------------------------------------------------------------

def _ricker(points, a):
    A = 2 / (np.sqrt(3 * a) * np.pi**0.25)
    t = np.arange(points) - (points - 1) / 2
    return A * (1 - (t / a) ** 2) * np.exp(-(t**2) / (2 * a**2))


def ricker_cwt(data, width):
    """Single-scale Ricker CWT row, matching scipy.signal.cwt."""
    data = np.asarray(data, dtype=float)
    N = min(10 * int(width), len(data))
    wav = _ricker(N, width)
    return np.convolve(data, wav[::-1], mode="same")


def _argrel(x, cmp):
    x = np.asarray(x)
    return np.where(cmp(x[1:-1], x[:-2]) & cmp(x[1:-1], x[2:]))[0] + 1


def local_extrema_oscillation(v, limit):
    """True if adjacent local extrema differ by less than ``limit``
    (models.py:600-609)."""
    imax = _argrel(v, np.greater)
    imin = _argrel(v, np.less)
    if len(imax) + len(imin) > 1:
        ind = np.sort(np.append(imax, imin))
        osci = np.abs(np.diff(np.asarray(v)[ind]))
        if np.any(osci > limit):
            return False
    return True


def cwt_oscillation(vsM, zM, limit=0.3):
    """CWT-based mantle oscillation prior (models.py:625-634)."""
    dz = zM[1] - zM[0]
    width = 30 // dz
    if width < 1:
        return True
    detrend = vsM - np.interp(zM, [zM[0], zM[-1]], [vsM[0], vsM[-1]])
    cwt = ricker_cwt(detrend, width)
    imax = _argrel(cwt, np.greater)
    imin = _argrel(cwt, np.less)
    ind = np.sort(np.append(imax, imin))
    if ind.size > 1 and np.any(np.abs(np.diff(cwt[ind])) > limit):
        return False
    return True


# ---------------------------------------------------------------------------
# lane-batched (torch) versions: v is (N, n), masks (n,) or (N, n)
# ---------------------------------------------------------------------------

def mono_increase(v, mask, eps=None):
    """all(diff(v) >= eps) over grid-adjacent masked entries, per lane."""
    eps = np.finfo(np.float64).eps if eps is None else eps
    dv = torch.diff(v, dim=-1)
    pair = mask[..., 1:] & mask[..., :-1]
    return torch.where(pair, dv >= eps, True).all(dim=-1)


def _next_flagged(flag):
    """(N, n) int64: index of the next flagged entry strictly after each
    position (n where there is none)."""
    n = flag.shape[-1]
    idx = torch.arange(n, device=flag.device).expand(flag.shape)
    idx = torch.where(flag, idx, n)
    after = torch.cat([idx[..., 1:], torch.full_like(idx[..., :1], n)], -1)
    return torch.flip(torch.cummin(torch.flip(after, [-1]), -1).values, [-1])


def _adjacent_flagged(vals, flag):
    """(pair, vals at the next flagged entry): pair[i] is True iff i is
    flagged and a flagged entry follows it."""
    n = flag.shape[-1]
    nxt = _next_flagged(flag)
    pair = flag & (nxt < n)
    nv = vals.gather(-1, nxt.clamp(max=n - 1))
    return pair, nv


def _adjacent_flagged_gap_ok(vals, flag, limit):
    """No adjacent flagged pair differs by more than ``limit``."""
    pair, nv = _adjacent_flagged(vals, flag)
    # a number becomes a fill on the device, not a copy from the host
    limit = (torch.as_tensor(limit, dtype=vals.dtype, device=vals.device)
             if torch.is_tensor(limit) else
             torch.full((), limit, dtype=vals.dtype, device=vals.device))
    if limit.dim() == 1:
        limit = limit[:, None]
    return ~(pair & ((nv - vals).abs() > limit)).any(dim=-1)


def group_jumps_positive(vs, grp_ids, keep):
    """The Vs jump at every group boundary between consecutive kept
    nodes is non-negative (Shen et al. 2012 constraint 5; models.py:
    585-588); ``keep`` drops layers thinner than 0.01 km as the host's
    compacted grid does (models.py:80)."""
    grp = torch.as_tensor(grp_ids, device=vs.device).expand(vs.shape)
    pair, nv = _adjacent_flagged(vs, keep)
    _, ng = _adjacent_flagged(grp, keep)
    return ~(pair & (ng != grp) & (nv < vs)).any(dim=-1)


def _inner(mask):
    return mask[..., 1:-1] & mask[..., :-2] & mask[..., 2:]


def local_extrema_oscillation_lanes(v, mask, limit):
    """Lane version of :func:`local_extrema_oscillation` on the masked
    entries; ``limit`` is a scalar or (N,)."""
    c, lft, rgt = v[..., 1:-1], v[..., :-2], v[..., 2:]
    is_ext = (((c > lft) & (c > rgt)) | ((c < lft) & (c < rgt))) & _inner(mask)
    return _adjacent_flagged_gap_ok(c, is_ext, limit)


def no_local_max(v, mask):
    c = v[..., 1:-1]
    is_max = (c > v[..., :-2]) & (c > v[..., 2:]) & _inner(mask)
    return ~is_max.any(dim=-1)


def cwt_oscillation_lanes(v, z, mask, limit=0.3):
    """Lane version of :func:`cwt_oscillation` (the JAX package's
    ``jnp_cwt_oscillation`` with its default kernel length n): the
    Ricker width follows each lane's own grid step, the kernel tail
    beyond 5 widths is zeroed."""
    N, n = v.shape
    mask = mask.expand(v.shape)
    nz = mask.sum(-1).clamp(min=2)
    dz = z[:, 1] - z[:, 0]
    width = torch.floor(30.0 / dz).clamp(min=1.0)[:, None]

    last = (nz - 1).clamp(0, n - 1)[:, None]
    v0, v1 = v[:, :1], v.gather(1, last)
    z0, z1 = z[:, :1], z.gather(1, last)
    line = v0 + (v1 - v0) * (z - z0) / torch.clamp(z1 - z0, min=1e-9)
    detrend = torch.where(mask, v - line, 0.0)

    t = (torch.arange(n, dtype=v.dtype, device=v.device) - (n - 1) / 2)[None]
    A = 2 / (torch.sqrt(3 * width) * math.pi**0.25)
    wav = A * (1 - (t / width) ** 2) * torch.exp(-(t**2) / (2 * width**2))
    wav = torch.where(t.abs() <= 5.0 * width, wav, 0.0)
    # np.convolve(detrend, wav[::-1], 'same') with len(wav) == n:
    # out[i] = sum_k detrend[k] * wav[n - 1 - s - i + k], s = (n - 1) // 2
    s = (n - 1) // 2
    i = torch.arange(n, device=v.device)
    e = (n - 1 - s) - i[:, None] + i[None, :]
    valid = (e >= 0) & (e < n)
    W = torch.where(valid, wav[:, e.clamp(0, n - 1)], 0.0)     # (N, n, n)
    cwt = (W * detrend[:, None, :]).sum(-1)

    c, lft, rgt = cwt[:, 1:-1], cwt[:, :-2], cwt[:, 2:]
    is_ext = (((c > lft) & (c > rgt)) | ((c < lft) & (c < rgt))) & _inner(mask)
    return _adjacent_flagged_gap_ok(c, is_ext, limit)

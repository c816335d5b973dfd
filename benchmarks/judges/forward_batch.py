"""Judge of the ``forward_batch`` entry: ``check_curves`` curves drawn
from the seed over every call of the window, solved again by the plain
float64 reference from the same input models.

Numbers compared (each against the traffic's ``limits``):

* ``phase_gap``: the largest |c - c_ref| (km/s) over the periods both
  solved;
* ``group_off_lanes``: the lanes (curve x period) there whose
  |u - u_ref| exceeds the traffic's ``group_off_kms``.  The largest
  group gap is not compared: the float32 tangents miss the float64
  group velocity by up to 1.17 km/s on one lane in tens of thousands,
  a third of what the bfloat16 control misses by on every lane, so no
  limit on it lies between the two; the count of lanes off holds every
  lane but those few;
* ``group_gap_p99``: the 99th percentile (linear between ranks) of
  |u - u_ref| (km/s) there;
* ``ok_mismatch``: periods that one side solved and the other did not.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import secular as SE


def judge(cell, out, seed, device, control=False):
    """[(name, value, limit)]; with ``control`` the judged curves are
    the reference's own with its secular function in bfloat16, the
    precision below the configuration's float32."""
    rng = np.random.default_rng([seed, 4])
    calls = out["calls"]
    S = int(cell.traffic["check_curves"])
    which = rng.integers(len(calls), size=S)
    B = calls[0][1].shape[0]
    model = torch.as_tensor(rng.integers(B, size=S), device=device)
    f64 = lambda x: x.to(torch.float64)  # noqa: E731
    parts = {k: [] for k in ("h", "vp", "vs", "rho", "qsi", "nlay", "c", "u",
                             "ok")}
    for j in np.unique(which):
        sel = model[torch.as_tensor(which == j, device=device)]
        b, c, u, ok = calls[j]
        for k, x in zip(("h", "vp", "vs", "rho", "qsi"), out["batches"][b]):
            parts[k].append(f64(x[sel]))
        parts["nlay"].append(out["nlay"][sel].to(torch.int64))
        for k, x in zip(("c", "u", "ok"), (c, u, ok)):
            parts[k].append(x[sel][..., 0])
    cat = {k: torch.cat(v) for k, v in parts.items()}
    nlay = cat["nlay"]
    inputs = [cat[k] for k in ("h", "vp", "vs", "rho", "qsi")]
    per = f64(out["periods"])
    c_ref, u_ref, ok_ref = SE.solve(*inputs, nlay, per, group=True)
    c, u, ok = f64(cat["c"]), f64(cat["u"]), cat["ok"]
    if control:
        c, u, ok = SE.solve(*inputs, nlay, per, group=True,
                            dtype=torch.bfloat16)
    both = ok & ok_ref
    gaps = lambda a, b: (a - b).abs()[both]  # noqa: E731
    checks = [("phase_gap", float(gaps(c, c_ref).max())),
              ("group_off_lanes", int((gaps(u, u_ref) > float(
                  cell.traffic["group_off_kms"])).sum())),
              ("group_gap_p99",
               float(torch.quantile(gaps(u, u_ref), 0.99))),
              ("ok_mismatch", int((ok != ok_ref).sum()))]
    lim = cell.traffic["limits"]
    return [(n, v, lim[n]) for n, v in checks]

"""Plain reference of the Cascadia-ocean layered model (pySurfInv's
``models.py`` CascadiaOcean with ``layers.py``'s OceanWater,
OceanSedimentCascadia, OceanCrust, OceanMantleHybrid and the reference
mantle below), written out for this one layer stack.

* :func:`parse_point` reads a setting and a point's local values into
  the stochastic parameters (value, bounds, step) and the fixed ones.
* :func:`host_profile` builds one model as the object API does
  (adaptive fine grids, scipy's cubic spline across the melt onset,
  thin rows dropped) and pads it for the solver.
* :func:`lane_grids` / :func:`lane_profile` build lanes of models from
  parameter tensors as the batched sampler does (fine grids frozen off
  the first point, a cubic Hermite bridge across the melt onset, thin
  rows kept at zero thickness); :func:`prior` is that sampler's prior.

Everything is float64 unless ``dtype`` says otherwise, on the device of
the inputs.  Nothing here imports the program.
"""

from __future__ import annotations

import math
from copy import deepcopy

import numpy as np
import torch

from reference import thermal as TH

LAYERS = ("OceanWater", "OceanSedimentCascadia", "OceanCrust",
          "OceanMantleHybrid")
BOUND_TYPES = ("abs", "abs_pos", "rel", "rel_pos")
WATER = (0.0, 1.475, 1.027, 10000.0)      # vs, vp, rho, qs
REF_H, REF_SLOPE, REF_NFINE = 300.0, 0.35 / 200, 20
GROUPS = ("water", "sediment", "crust", "mantle", "mantle")


# ---- settings ------------------------------------------------------------

def _bounds(v, kind, width, step):
    lo = {"abs": v - width, "abs_pos": max(v - width, 0),
          "rel": v * (1 - width / 100), "rel_pos": max(v * (1 - width / 100), 0)}
    hi = {"abs": v + width, "abs_pos": max(v + width, 0),
          "rel": v * (1 + width / 100), "rel_pos": max(v * (1 + width / 100), 0)}
    half = abs(hi[kind] - lo[kind]) / 2
    return lo[kind], hi[kind], half if step > half else step


def _entry(v):
    """(value, (vmin, vmax, step) or None) of one setting entry."""
    if isinstance(v, list):
        if v[1] in ("fixed", "total"):
            return float(v[0]), None
        if v[1] in BOUND_TYPES:
            return float(v[0]), _bounds(float(v[0]), v[1], v[2], v[3])
        raise ValueError(f"setting entry {v!r} is not used by this model")
    return float(v), None


def _set_first(d, key, value):
    if isinstance(d[key], list):
        d[key][0] = value
    else:
        d[key] = value


def parse_point(setting, local):
    """The point's parameters.  Returns a dict: ``names`` of the
    stochastic parameters in the sampler's order, ``theta0``, ``vmin``,
    ``vmax``, ``step`` (numpy float64), ``fixed`` (name -> float) and the
    model ``info``."""
    s = deepcopy(setting)
    info = dict(s.pop("Info"))
    if list(s) != list(LAYERS) or info.get("modelType") != "CascadiaOcean":
        raise ValueError("the reference builds the Cascadia-ocean stack "
                         f"{LAYERS} only, got {list(s)}")
    info.update(local)
    topo = local.get("topo", info.get("topo", 0))
    if max(-topo, 0) <= 0:
        raise ValueError("the reference needs a water layer (topo < 0)")
    _set_first(s["OceanWater"], "H", max(-topo, 0))
    if "sedthk" in local:
        _set_first(s["OceanSedimentCascadia"], "H", local["sedthk"])
    m = s["OceanMantleHybrid"]
    if m.get("Conversion", "Ritzwoller") != "Ritzwoller":
        raise ValueError("the reference converts with Ritzwoller only")
    if "lithoAge" in local:
        if isinstance(m["ThermAge"], list):
            m["ThermAge"][0] = local["lithoAge"]
            if m["ThermAge"][1] in ("rel_pos", "rel") and local["lithoAge"] < 2:
                m["ThermAge"][1] = "abs_pos"
                m["ThermAge"][2] = 2 * m["ThermAge"][2] / 100
        else:
            m["ThermAge"] = local["lithoAge"]
    for i, v in enumerate(local.get("mantleInitParmVs", ())):
        if isinstance(m["Vs"][i], list):
            m["Vs"][i][0] = v
        else:
            m["Vs"][i] = v
    info.pop("mantleInitParmVs", None)
    entries = [("water.H", s["OceanWater"]["H"]),
               ("sed.H", s["OceanSedimentCascadia"]["H"]),
               ("crust.H", s["OceanCrust"]["H"]),
               ("crust.Vs0", s["OceanCrust"]["Vs"][0]),
               ("crust.Vs1", s["OceanCrust"]["Vs"][1]),
               ("mantle.BottomDepth", m["BottomDepth"]),
               ("mantle.ThermAge", m["ThermAge"])]
    entries += [(f"mantle.Vs{i}", v) for i, v in enumerate(m["Vs"])]
    names, spec, fixed = [], [], {}
    for name, v in entries:
        val, sp = _entry(v)
        fixed[name] = val
        if sp is not None:
            names.append(name)
            spec.append((val,) + sp)
    spec = np.array(spec, np.float64).reshape(-1, 4)
    return dict(names=names, theta0=spec[:, 0], vmin=spec[:, 1],
                vmax=spec[:, 2], step=spec[:, 3], fixed=fixed, info=info,
                nvs=len(m["Vs"]))


# ---- shared pieces -----------------------------------------------------

def bspline_basis(n, n_basis, alpha=2.0):
    """(n_basis, n) cubic-or-quartic B-spline basis on [0, 1] with
    geometric knot spacing (layers.py:4-45)."""
    if n_basis == 1:
        return np.ones((1, n))
    if n_basis == 2:
        return np.stack([np.linspace(1.0, 0.0, n), np.linspace(0.0, 1.0, n)])
    deg = 3 + (n_basis >= 4)
    eps = np.finfo(float).eps
    m = n_basis
    x = np.zeros(m + deg)
    x[: deg - 1] = -eps
    x[deg - 1] = 0.0
    x[deg:m] = np.power(alpha, np.arange(m - deg)) * (alpha - 1) / (
        np.power(alpha, m - deg + 1) - 1)
    x[m] = 1.0
    x[m + 1:] = 1.0 + eps
    z = np.linspace(0.0, 1.0, n)
    nb = len(x) - 1
    b = np.zeros((n, nb))
    for i in range(nb):
        b[(z >= x[i]) & (z < x[i + 1]), i] = 1.0
    for k in range(1, deg):
        nxt = np.zeros_like(b)
        for i in range(nb - k):
            left, right = x[i + k] - x[i], x[i + k + 1] - x[i + 1]
            if left != 0.0:
                nxt[:, i] += b[:, i] * (z - x[i]) / left
            if right != 0.0:
                nxt[:, i] += b[:, i + 1] * (x[i + k + 1] - z) / right
        b = nxt
    return np.ascontiguousarray(b[:, :m].T)


def _adaptive_n(H):
    return 60 if H >= 150 else 30 if H > 60 else 15 if H > 20 else \
        10 if H > 10 else 5


def _crust_nfine(H):
    return min(max(int(round(H / 2)), 2), 10)


def _sediment_vs(H):
    return (0.02 * H ** 2 + 1.27 * H + 0.29 * 0.1) / (H + 0.29)


def _mantle_others(vs):
    return vs * 1.76, 3.4268 + (vs - 4.5) / 4.5


def _melt_onset(age, zdeps):
    """First depth of ``zdeps`` where T > 0.92x the damp solidus (the
    last depth if none), per row of age (N, 1)."""
    T = TH.hscm_temperature(age, zdeps)
    hot = T > 0.92 * TH.solidus_ruan(TH.pressure(zdeps))
    first = zdeps[torch.argmax(hot.to(torch.int8), dim=-1)]
    return torch.where(hot.any(dim=-1), first, zdeps[-1])


def _thermal_vs(age, z_km):
    return TH.ritzwoller_vs(TH.hscm_temperature(age, z_km), TH.pressure(z_km))


def _qs(age, z_km, period):
    T = TH.hscm_temperature(age, z_km)
    P = TH.pressure(z_km)
    return torch.clamp(TH.ruan_qs(T, P, TH.density(P, T), period), max=5000.0)


# ---- the object API's build (one model) -----------------------------------

def host_profile(pt, L=None):
    """The padded solver stack of one point's model as ``Model1D``
    builds it with its reference layer: (h, vp, vs, rho, qsinv) numpy
    float64 (L,) and the real-layer count."""
    from scipy.interpolate import CubicSpline

    f, info = pt["fixed"], pt["info"]
    lin = lambda n: torch.linspace(0.0, 1.0, n, dtype=torch.float64)  # noqa
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    cols = []  # (z, vs, vp, rho, qs, group) per layer, z absolute
    z0 = -max(info.get("topo", 0) or 0, 0)

    def push(z, vs, vp, rho, qs, grp):
        if float(z[-1] - z[0]) < 0.01:
            raise ValueError("the reference keeps every layer of the stack")
        one = torch.ones_like(z)
        cols.append([z + z0, vs * one, vp * one, rho * one, qs * one, grp])
        return float(z[-1] + z0)

    Hw = f["water.H"]
    z0 = push(t([0.0, Hw]), *(t(x) for x in WATER), "water")
    Hs = f["sed.H"]
    vs = t(_sediment_vs(Hs))
    vp = vs * 1.23 + 1.28
    z0 = push(lin(2) * Hs, vs, vp, 0.541 + 0.3601 * vp, t(80.0), "sediment")
    Hc = f["crust.H"]
    zc = lin(_crust_nfine(Hc) + 1) * Hc
    v0, v1 = f["crust.Vs0"], f["crust.Vs1"]
    vs = v0 + (v1 - v0) * lin(len(zc))
    vp = vs * 1.8
    z0 = push(zc, vs, vp, 0.541 + 0.3601 * vp, t(350.0), "crust")
    # the hybrid mantle: thermal Vs below the crust, spline-merged into
    # the perturbed profile across the melt onset
    zs = np.concatenate([c[0].numpy() for c in cols])
    grp = sum(([c[5]] * len(c[0]) for c in cols), [])
    h = np.diff(zs)
    keep = h > 0.01
    crustH = float(np.sum(h[keep][np.array(grp[:-1])[keep] == "crust"]))
    Hm = f["mantle.BottomDepth"] - z0
    zm = lin(_adaptive_n(Hm) + 1) * Hm
    age = torch.clamp(t(f["mantle.ThermAge"]), min=1e-3)
    v_th = _thermal_vs(age, crustH + zm)
    z_melt = float(_melt_onset(age[None, None],
                               torch.linspace(0.0, 200.0, 200,
                                              dtype=torch.float64))[0]) - crustH
    coef = t([0.0] + [f[f"mantle.Vs{i}"] for i in range(pt["nvs"])])
    v_pert = coef @ t(bspline_basis(len(zm), len(coef))) + v_th
    xL, xH = z_melt, (z_melt + crustH) * 1.7 - crustH
    zn, y1, y2 = zm.numpy(), v_th.numpy(), v_pert.numpy()
    xs = list(zn[zn < xL]) + list(zn[zn > xH])
    ys = list(y1[zn < xL]) + list(y2[zn > xH])
    vs = t(CubicSpline(xs, ys)(zn))
    qage = info.get("lithoAge") if info.get("lithoAgeQ", False) else None
    qage = f["mantle.ThermAge"] if qage is None else qage
    qs = _qs(torch.clamp(t(qage), min=1e-3), z0 + zm, info.get("period", 1))
    vp, rho = _mantle_others(vs)
    z0 = push(zm, vs, vp, rho, qs, "mantle")
    if info.get("refLayer", False):
        zr = lin(REF_NFINE + 1) * REF_H
        last = [c[-1] for c in cols[-1][1:5]]
        vs = last[0] + float(zr[-1] - zr[0]) * REF_SLOPE * lin(len(zr))
        vp, rho = _mantle_others(vs)
        push(zr, vs, last[1] + (vp - vp[0]), last[2] + (rho - rho[0]),
             last[3] + torch.zeros_like(vs), "mantle")
    z, vs, vp, rho, qs = (np.concatenate([c[k].numpy() for c in cols])
                          for k in range(5))
    h = np.diff(z)
    mid = lambda x: (x[1:] + x[:-1]) / 2  # noqa: E731
    keep = (h > 0.01) & (h > 1e-3)
    h, vs, vp, rho, qs = h[keep], mid(vs)[keep], mid(vp)[keep], \
        mid(rho)[keep], mid(qs)[keep]
    n = len(h)
    L = int(-(-n // 8) * 8) if L is None else L
    pad = lambda x, v: np.concatenate([x, np.full(L - n, v)])  # noqa: E731
    return (pad(h, 0.0), pad(vp, vp[-1]), pad(vs, vs[-1]), pad(rho, rho[-1]),
            pad(1.0 / qs, 1.0 / qs[-1]), n)


# ---- the batched sampler's build (lanes) ----------------------------------

class Structure:
    """The frozen lane layout, taken off the first point's model: fine
    node counts per layer (water, sediment, crust, mantle, reference)."""

    def __init__(self, pt):
        f = pt["fixed"]
        z_top = f["water.H"] + f["sed.H"] + f["crust.H"]
        self.nodes = (2, 2, _crust_nfine(f["crust.H"]) + 1,
                      _adaptive_n(f["mantle.BottomDepth"] - z_top) + 1,
                      REF_NFINE + 1)
        self.names = pt["names"]
        self.nvs = pt["nvs"]
        self.info = pt["info"]
        self.n_main = sum(self.nodes[:4])
        rows = sum(self.nodes) - 1
        self.L = int(-(-rows // 8) * 8)
        grp = sum(([g] * n for g, n in zip(GROUPS, self.nodes)), [])
        self.grp = np.array(grp[: self.n_main])
        self.starts = np.cumsum((0,) + self.nodes[:3])
        self.ends = self.starts + np.array(self.nodes[:4]) - 1


def lane_params(st, pts, thetas, dtype=torch.float64):
    """Name -> (N, 1) tensor: the stochastic parameters from ``thetas``
    (N, ntheta) and the fixed ones from each lane's point (``pts``, a
    list of parsed points, one a lane)."""
    dev = thetas.device
    out = {}
    for name in pts[0]["fixed"]:
        if name in st.names:
            out[name] = thetas[:, st.names.index(name)].to(dtype)[:, None]
        else:
            out[name] = torch.tensor([p["fixed"][name] for p in pts],
                                     dtype=dtype, device=dev)[:, None]
    for key in ("lithoAge", "topo"):
        out["info." + key] = torch.tensor(
            [float(p["info"].get(key, 0) or 0) for p in pts], dtype=dtype,
            device=dev)[:, None]
    return out


def _hermite(z, y1, y2, xL, xH):
    """y1 above xL, y2 below xH, a cubic Hermite bridge between the last
    kept points with one-sided difference slopes."""
    n = z.shape[1]
    dz = z[:, 1:2] - z[:, :1]
    iL = ((z < xL).sum(1, keepdim=True) - 1).clamp(1, n - 2)
    iH = (n - (z > xH).sum(1, keepdim=True)).clamp(1, n - 2)
    at = lambda a, i: a.gather(1, i)  # noqa: E731
    zL, zH = at(z, iL), at(z, iH)
    yL, yH = at(y1, iL), at(y2, iH)
    sL = (yL - at(y1, iL - 1)) / dz
    sH = (at(y2, iH + 1) - yH) / dz
    span = torch.maximum(zH - zL, dz)
    s = torch.clamp((z - zL) / span, 0.0, 1.0)
    bridge = ((2 * s ** 3 - 3 * s ** 2 + 1) * yL
              + (s ** 3 - 2 * s ** 2 + s) * span * sL
              + (-2 * s ** 3 + 3 * s ** 2) * yH + (s ** 3 - s ** 2) * span * sH)
    return torch.where(z < zL, y1, torch.where(z > zH, y2, bridge))


def lane_grids(st, p, vs_only=False):
    """Node grids (z, vs, vp, rho, qs), each (N, n_nodes), of the lanes
    whose parameters are ``p`` (see :func:`lane_params`)."""
    ref = p["water.H"]
    dt, dev = ref.dtype, ref.device
    lin = lambda n: torch.as_tensor(np.linspace(0.0, 1.0, n), dtype=dt,  # noqa
                                    device=dev)[None]
    one = lambda x: x * torch.ones_like(z)  # noqa: E731
    parts = []
    z_last = -torch.clamp(p["info.topo"], min=0.0)

    def push(z, vs, vp, rho, qs):
        zab = z + z_last
        parts.append([zab, vs, vp, rho, qs])
        return zab[:, -1:]

    H = p["water.H"]
    z = torch.cat([torch.zeros_like(H), H], dim=1)
    z_last = push(z, *(one(torch.full_like(z, v)) for v in WATER))
    H = p["sed.H"]
    z = lin(2) * H
    vs = one(_sediment_vs(H))
    vp = vs * 1.23 + 1.28
    z_last = push(z, vs, vp, 0.541 + 0.3601 * vp, one(torch.full_like(z, 80.0)))
    top = z_last
    z = lin(st.nodes[2]) * p["crust.H"]
    v0, v1 = p["crust.Vs0"], p["crust.Vs1"]
    vs = v0 + (v1 - v0) * lin(z.shape[1])
    vp = vs * 1.8
    z_last = push(z, vs, vp, 0.541 + 0.3601 * vp, one(torch.full_like(z, 350.0)))
    crustH = z_last - top
    z = lin(st.nodes[3]) * (p["mantle.BottomDepth"] - z_last)
    age = torch.clamp(p["mantle.ThermAge"], min=1e-3)
    v_th = _thermal_vs(age, crustH + z)
    zmelt = _melt_onset(age, torch.as_tensor(np.linspace(0.0, 200.0, 200),
                                             dtype=dt, device=dev))
    z_melt = zmelt[:, None] - crustH
    basis = torch.as_tensor(bspline_basis(z.shape[1], st.nvs + 1), dtype=dt,
                            device=dev)
    v_pert = torch.zeros_like(z) * basis[0]
    for i in range(st.nvs):
        v_pert = v_pert + p[f"mantle.Vs{i}"] * basis[i + 1]
    vs = _hermite(z, v_th, v_pert + v_th, z_melt,
                  (z_melt + crustH) * 1.7 - crustH)
    if vs_only:
        zero = torch.zeros_like(vs)
        push(z, vs, zero, zero, zero)
        z, vs = (torch.cat([q[k] for q in parts], dim=1) for k in (0, 1))
        return z, vs
    qage = (p["info.lithoAge"] if st.info.get("lithoAgeQ", False)
            else p["mantle.ThermAge"])
    qs = _qs(torch.clamp(qage, min=1e-3), z_last + z, st.info.get("period", 1))
    vp, rho = _mantle_others(vs)
    z_last = push(z, vs, vp, rho, qs)
    z = lin(st.nodes[4]) * REF_H
    last = [q[:, -1:] for q in parts[-1][1:5]]
    vs = last[0] + (z[:, -1:] - z[:, :1]) * REF_SLOPE * lin(z.shape[1])
    vp, rho = _mantle_others(vs)
    push(z, vs, last[1] + (vp - vp[:, :1]), last[2] + (rho - rho[:, :1]),
         last[3] + torch.zeros_like(vs))
    return tuple(torch.cat([q[k] for q in parts], dim=1) for k in range(5))


def lane_profile(st, p):
    """Padded solver stacks (h, vp, vs, rho, qsinv), each (N, L), and the
    (N,) real-layer count: node midpoints, rows of h <= 0.01 at zero
    thickness, the halfspace row replicated into the padding."""
    z, vs, vp, rho, qs = lane_grids(st, p)
    h = torch.diff(z, dim=1)
    mid = lambda x: 0.5 * (x[:, 1:] + x[:, :-1])  # noqa: E731
    h = torch.where(h <= 0.01, torch.zeros_like(h), h)
    pad = st.L - h.shape[1]
    rep = lambda x: torch.cat([x, x[:, -1:].expand(-1, pad)], dim=1)  # noqa
    nlay = torch.full((h.shape[0],), h.shape[1], dtype=torch.int64,
                      device=h.device)
    return (torch.cat([h, h.new_zeros(h.shape[0], pad)], dim=1),
            rep(mid(vp)), rep(mid(vs)), rep(mid(rho)), rep(1.0 / mid(qs)),
            nlay)


# ---- the sampler's prior ---------------------------------------------------

def _next_flagged(flag):
    n = flag.shape[-1]
    idx = torch.arange(n, device=flag.device).expand(flag.shape)
    idx = torch.where(flag, idx, n)
    after = torch.cat([idx[..., 1:], torch.full_like(idx[..., :1], n)], -1)
    return torch.flip(torch.cummin(torch.flip(after, [-1]), -1).values, [-1])


def _pairs(vals, flag):
    n = flag.shape[-1]
    nxt = _next_flagged(flag)
    return flag & (nxt < n), vals.gather(-1, nxt.clamp(max=n - 1))


def _extrema_gap_ok(v, mask, limit):
    """No two consecutive local extrema of v (on the masked nodes) differ
    by more than ``limit`` (N, 1)."""
    c, lft, rgt = v[..., 1:-1], v[..., :-2], v[..., 2:]
    inner = mask[..., 1:-1] & mask[..., :-2] & mask[..., 2:]
    ext = (((c > lft) & (c > rgt)) | ((c < lft) & (c < rgt))) & inner
    pair, nv = _pairs(c, ext)
    return ~(pair & ((nv - c).abs() > limit)).any(dim=-1)


def _cwt_ok(v, z, limit=0.3):
    """The mantle oscillation prior: the Ricker transform (width 30 km
    over the lane's grid step, kernel cut at 5 widths) of the detrended
    profile has no consecutive extrema more than ``limit`` apart."""
    N, n = v.shape
    dz = z[:, 1] - z[:, 0]
    width = torch.floor(30.0 / dz).clamp(min=1.0)[:, None]
    line = v[:, :1] + (v[:, -1:] - v[:, :1]) * (z - z[:, :1]) / torch.clamp(
        z[:, -1:] - z[:, :1], min=1e-9)
    d = v - line
    t = (torch.arange(n, dtype=v.dtype, device=v.device) - (n - 1) / 2)[None]
    A = 2 / (torch.sqrt(3 * width) * math.pi ** 0.25)
    wav = A * (1 - (t / width) ** 2) * torch.exp(-(t ** 2) / (2 * width ** 2))
    wav = torch.where(t.abs() <= 5.0 * width, wav, torch.zeros_like(wav))
    s = (n - 1) // 2
    i = torch.arange(n, device=v.device)
    e = (n - 1 - s) - i[:, None] + i[None, :]
    W = torch.where((e >= 0) & (e < n), wav[:, e.clamp(0, n - 1)],
                    torch.zeros((), dtype=v.dtype, device=v.device))
    cwt = (W * d[:, None, :]).sum(-1)
    return _extrema_gap_ok(cwt, torch.ones_like(cwt, dtype=torch.bool), limit)


def prior(st, p):
    """The batched sampler's prior (CascadiaOcean.isgood) of each lane,
    (N,) bool, on the grids without the reference layer; layers thinner
    than 0.01 km take part in no check."""
    z, vs = lane_grids(st, p, vs_only=True)
    n = st.n_main
    z, vs = z[:, :n], vs[:, :n]
    dev = z.device
    g = lambda name: torch.as_tensor(st.grp == name, device=dev)  # noqa
    sed, crust, mantle = g("sediment"), g("crust"), g("mantle")
    starts = torch.as_tensor(st.starts, device=dev)
    ends = torch.as_tensor(st.ends, device=dev)
    layer = torch.as_tensor(np.repeat(np.arange(4), st.nodes[:4]), device=dev)
    keep = ((z[:, ends] - z[:, starts]) > 0.01)[:, layer]
    ok = torch.where(sed & keep, vs >= 0.2, True).all(dim=1)
    codes = torch.as_tensor(np.cumsum(np.r_[0, st.grp[1:] != st.grp[:-1]]),
                            device=dev).expand(vs.shape)
    pair, nv = _pairs(vs, keep)
    _, ng = _pairs(codes, keep)
    ok &= ~(pair & (ng != codes) & (nv < vs)).any(dim=-1)
    for m in (sed & keep, crust & keep):
        pm = m[..., 1:] & m[..., :-1]
        ok &= torch.where(pm, torch.diff(vs, dim=-1) >= -1e-12, True).all(-1)
    ok &= ((vs[:, -1] - vs[:, -2])
           / torch.clamp(z[:, -1] - z[:, -2], min=1e-9)) > 0
    meanM = torch.where(mantle, vs, 0.0).sum(dim=1) / max(int(mantle.sum()), 1)
    mm = mantle.expand(vs.shape)
    ok &= _extrema_gap_ok(vs, mm, 0.1 * meanM[:, None])
    c = vs[..., 1:-1]
    inner = mm[..., 1:-1] & mm[..., :-2] & mm[..., 2:]
    ok &= ~((c > vs[..., :-2]) & (c > vs[..., 2:]) & inner).any(dim=-1)
    i0 = int(np.argmax(st.grp == "mantle"))
    zM, vM = z[:, i0:], vs[:, i0:]
    slope = torch.diff(vM, dim=1) / torch.clamp(torch.diff(zM, dim=1), min=1e-9)
    ok &= slope.min(dim=1).values >= slope[:, 0] * 1.5
    ok &= _cwt_ok(vM, zM)
    return ok


def misfit(c, obs_c, uncer, periods, obs_m):
    """The band-split misfit of Cascadia points (point.py:336-366):
    (misfit, chi^2 soft-capped above 50), each (N,); 88888 where any
    observed period has no root (c < 0.01)."""
    ok = torch.where(obs_m, c >= 0.01, True).all(dim=-1)
    lo, hi = obs_m & (periods <= 40), obs_m & (periods > 40)
    n_lo, n_hi = lo.sum(-1), hi.sum(-1)
    N = (n_lo + n_hi).clamp(min=1)
    b2 = torch.where(obs_m, ((obs_c - c) / uncer) ** 2, 0.0)
    m_lo = torch.where(lo, b2, 0.0).sum(-1) / n_lo.clamp(min=1)
    m_hi = torch.where(hi, b2, 0.0).sum(-1) / n_hi.clamp(min=1)
    chi = torch.where((n_lo > 0) & (n_hi > 0), (m_lo + m_hi) / 2 * N,
                      torch.where(n_lo > 0, m_lo * N, m_hi * N))
    m = torch.sqrt(chi / N)
    chi = torch.where(chi < 50, chi, torch.sqrt(chi * 50.0))
    fail = torch.full_like(chi, 88888.0)
    return torch.where(ok, m, fail), torch.where(ok, chi, fail)

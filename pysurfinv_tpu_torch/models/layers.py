"""Seismic layer catalog: parameters -> fine grids of (z, vs, vp, rho, qs, qp).

Capability spec from the reference pySurfInv's ``layers.py``.  Every
concrete layer type reproduces the reference's parameterization and
empirical rock-property relations (vp/rho/qs/qp from vs).  Two modes, as
in the JAX package's layer classes:

  * host mode — ``parm`` holds plain floats, grids are float64 CPU
    tensors, fine-layer counts are adaptive exactly as in the reference,
    and the melt-onset merge of the hybrid thermal layer uses scipy's
    CubicSpline;
  * lane mode (the JAX package's traced mode) — ``seisPropGrids`` gets
    ``lanes=`` an (N,) reference tensor (its dtype and device are the
    grids'), a static ``nFine``, ``layersAbove`` as the per-lane last
    (z, vs, vp, rho, qs, qp) values, each (N,), and ``parm`` values that
    are (N,) lane tensors or constants.  Every grid comes back (N,
    nFine + 1); the hybrid layer's merge is a cubic-Hermite bridge (see
    ``OceanMantleHybrid._merge_lanes``).  This is what
    ``inversion.compiled.CompiledModel`` builds a whole batch of
    proposals with.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from pysurfinv_tpu_torch.models.bspline import bspline_basis
from pysurfinv_tpu_torch.models.brownian import BrownianVar, BrownianVarMC
from pysurfinv_tpu_torch.utils import _dictIterModifier, device_constant

_F64 = torch.float64


def _vec(x):
    return torch.as_tensor(x, dtype=_F64)


def _linspace01(n):
    return torch.linspace(0.0, 1.0, n, dtype=_F64)


def _full(n, v):
    return torch.full((n,), v, dtype=_F64)


def _col(v, ref):
    """A parm value in lane mode as an (N, 1) column of ``ref``'s dtype
    and device: a lane tensor (N,) or a constant."""
    if torch.is_tensor(v):
        return v.to(ref).reshape(-1, 1)
    return torch.full((ref.shape[0], 1), float(v), dtype=ref.dtype,
                      device=ref.device)


def _lin01(n, ref):
    """linspace(0, 1, n) rounded as numpy (and jnp) round it, (1, n)."""
    return device_constant(("linspace01", n), lambda: np.linspace(0.0, 1.0, n),
                           ref.dtype, ref.device)[None]


def _basis_lanes(n_z, n_basis, deg, ref):
    """The (n_basis, n_z) B-spline basis in ``ref``'s dtype, on its
    device."""
    return device_constant(("bspline", n_z, n_basis, deg),
                           lambda: bspline_basis(n_z, n_basis, deg),
                           ref.dtype, ref.device)


def _lane_fill(x, v):
    return torch.full_like(x, v)


def _spline_lanes(vals, basis, ref):
    """sum_i vals[i] * basis[i] per lane: (N, n_z) from coefficients
    that are lane tensors or constants and a :func:`_basis_lanes` basis.
    Written as elementwise multiply-adds so a lane's grid does not depend
    on the batch it is built in (a matrix product's kernel choice can
    depend on N)."""
    acc = _col(vals[0], ref) * basis[0]
    for v, b in zip(vals[1:], basis[1:]):
        acc = acc + _col(v, ref) * b
    return acc


class SeisLayer:
    """Base layer (layers.py:48-81): parm dict + group/name properties."""

    def __init__(self, parm=None, prop=None):
        self.parm = {} if parm is None else parm
        self.prop = {"Group": None, "LayerName": None}
        self.prop.update(prop or {})

    def seisPropGrids(self, **kwargs):
        return None, None, None, None, None, None

    def seisPropLayers(self, **kwargs):
        z, vs, vp, rho, qs, qp = self.seisPropGrids(**kwargs)
        h = torch.diff(z)
        mid = lambda x: (x[1:] + x[:-1]) / 2  # noqa: E731
        return h, mid(vs), mid(vp), mid(rho), mid(qs), mid(qp)

    def _perturb(self, reset=False):
        mod = (lambda v: v.reset()) if reset else (lambda v: v.move())
        new = self.copy()
        new.parm = _dictIterModifier(
            self.parm, lambda v: isinstance(v, BrownianVar), mod)
        return new

    def _reset(self):
        return self._perturb(reset=True)

    def copy(self):
        return deepcopy(self)


def _lane_rows(v, ref):
    """A profile-valued parm in lane mode as (N, n) rows of ``ref``'s
    dtype and device: an (n,) profile shared by every lane, or an (N, n)
    lane tensor."""
    t = (v.to(ref) if torch.is_tensor(v)
         else torch.as_tensor(np.asarray(v, dtype=float), dtype=ref.dtype,
                              device=ref.device))
    return t.expand(ref.shape[0], -1) if t.dim() == 1 else t


class PureLayer(SeisLayer):
    """Layer-profile layer: ``parm`` holds h, vs, vp, rho, qs, qp.  In
    lane mode (``lanes=`` an (N,) reference tensor) each comes back as
    (N, n) rows; see :func:`_lane_rows`."""

    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "PureLayer"})

    def seisPropLayers(self, **kwargs):
        p, ref = self.parm, kwargs.get("lanes")
        keys = ("h", "vs", "vp", "rho", "qs", "qp")
        if ref is not None:
            return tuple(_lane_rows(p[k], ref) for k in keys)
        return tuple(_vec(p[k]) for k in keys)

    def H(self, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            return _lane_rows(self.parm["h"], ref).sum(dim=-1)
        return _vec(self.parm["h"]).sum()


class PureGrid(SeisLayer):
    """Grid-profile layer: ``parm`` holds z, vs, vp, rho, qs, qp at the
    grid nodes.  In lane mode (``lanes=`` an (N,) reference tensor) each
    comes back as (N, n) rows; see :func:`_lane_rows`."""

    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "PureGrid"})

    def seisPropGrids(self, **kwargs):
        p, ref = self.parm, kwargs.get("lanes")
        keys = ("z", "vs", "vp", "rho", "qs", "qp")
        if ref is not None:
            return tuple(_lane_rows(p[k], ref) for k in keys)
        return tuple(_vec(p[k]) for k in keys)

    def H(self, **kwargs):
        ref = kwargs.get("lanes")
        z = (_vec(self.parm["z"]) if ref is None
             else _lane_rows(self.parm["z"], ref))
        return z[..., -1] - z[..., 0]


class SeisLayerVs(SeisLayer):
    """Template: H + Vs parameterization, empirical others (layers.py:109)."""

    def seisPropGrids(self, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            return self._laneGrids(ref, **kwargs)
        N = kwargs.get("nFine") or self._nFineLayers(**kwargs)
        H = float(self._calH(**kwargs))
        z = _linspace01(N + 1) * H
        vs = self._calVs(z, **kwargs)
        vp, rho, qs, qp = self._calOthers(z, vs, **kwargs)
        return z, vs, vp, rho, qs, qp

    def _laneGrids(self, ref, **kwargs):
        """Lane mode: (N, nFine + 1) grids.  ``vs_only`` skips
        ``_calOthers`` (vp/rho/qs/qp come back as zeros): the priors
        read only (z, vs), which are computed by the same code as the
        full build."""
        z = _lin01(kwargs["nFine"] + 1, ref) * self._calH_lanes(ref, **kwargs)
        vs = self._calVs(z, **kwargs)
        if kwargs.get("vs_only"):
            zero = torch.zeros_like(vs)
            return z, vs, zero, zero, zero, zero
        vp, rho, qs, qp = self._calOthers(z, vs, **kwargs)
        return z, vs, vp, rho, qs, qp

    def _calH(self, **kwargs):
        if "BottomDepth" in self.parm:
            z0 = kwargs["layersAbove"][0][-1]
            return self.parm["BottomDepth"] - z0
        return self.parm["H"]

    def _calH_lanes(self, ref, **kwargs):
        """(N, 1) thickness in lane mode."""
        if "BottomDepth" in self.parm:
            z0 = kwargs["layersAbove"][0][:, None]
            return _col(self.parm["BottomDepth"], ref) - z0
        return _col(self.parm["H"], ref)

    def _nFineLayers(self, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def _calVs(self, z, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def _calOthers(self, z, vs, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def _bspl(self, n_z, n_basis, deg=None):
        return _vec(bspline_basis(n_z, n_basis, deg))

    @staticmethod
    def _adaptiveN(H):
        """Crust/mantle fine-layer ladder (layers.py:161-173)."""
        if H >= 150:
            return 60
        if H > 60:
            return 30
        if H > 20:
            return 15
        if H > 10:
            return 10
        return 5


def _brocher_rho(vs):
    """Land sediment/crust density polynomial (layers.py:152, 186)."""
    return (1.22679 + 1.53201 * vs - 0.83668 * vs**2 + 0.20673 * vs**3
            - 0.01656 * vs**4)


class Sediment(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "LandSediment", "Group": "sediment"})

    def _nFineLayers(self, **kwargs):
        return 1

    def _calVs(self, z, **kwargs):
        v = self.parm["Vs"]
        ref = kwargs.get("lanes")
        if ref is not None:
            if isinstance(v, (list, tuple)):
                v0, v1 = _col(v[0], ref), _col(v[1], ref)
                return v0 + (v1 - v0) * _lin01(z.shape[1], ref)
            return _col(v, ref) * torch.ones_like(z)
        if isinstance(v, (list, tuple)):
            return torch.linspace(float(v[0]), float(v[1]), len(z),
                                  dtype=_F64)
        return _full(len(z), float(v))

    def _calOthers(self, z, vs, **kwargs):
        return (vs * 2.0, _brocher_rho(vs), _lane_fill(vs, 80.0),
                _lane_fill(vs, 160.0))


class Crust(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "LandCrust", "Group": "crust"})

    def _nFineLayers(self, **kwargs):
        return self._adaptiveN(float(self._calH(**kwargs)))

    def _calVs(self, z, **kwargs):
        ref = kwargs.get("lanes")
        gauss = self.parm.get("Gauss", False)
        if ref is not None:
            vs = _spline_lanes(self.parm["Vs"], _basis_lanes(
                z.shape[1], len(self.parm["Vs"]), None, ref), ref)
            if gauss is not False:
                A, mu, sig = (_col(x, ref) for x in gauss)
                vs = vs + A * torch.exp(-0.5 * ((z - mu) / sig) ** 2)
            return vs
        coef = _vec([float(v) for v in self.parm["Vs"]])
        basis = self._bspl(len(z), len(self.parm["Vs"]))
        vs = coef @ basis
        if gauss is not False:
            A, mu, sig = (float(x) for x in gauss)
            vs = vs + A * torch.exp(-0.5 * ((z - mu) / sig) ** 2)
        return vs

    def _calOthers(self, z, vs, **kwargs):
        return (vs * 1.80, _brocher_rho(vs), _lane_fill(vs, 600.0),
                _lane_fill(vs, 1400.0))


class OceanWater(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanWater", "Group": "water"})
        self.parm["Vs"] = 0

    def seisPropGrids(self, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            H = self._calH_lanes(ref, **kwargs)
            z = torch.cat([torch.zeros_like(H), H], dim=1)
            two = torch.ones_like(z)
        else:
            H = float(self._calH(**kwargs))
            z = _vec([0.0, H])
            two = torch.ones(2, dtype=_F64)
        return (z, 0.0 * two, 1.475 * two, 1.027 * two,
                10000.0 * two, 57822.0 * two)


class OceanSediment(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanSediment", "Group": "sediment"})

    def _nFineLayers(self, **kwargs):
        return 1

    def _calVs(self, z, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            return _col(self.parm["Vs"], ref) * torch.ones_like(z)
        return float(self.parm["Vs"]) * torch.ones(len(z), dtype=_F64)

    def _calOthers(self, z, vs, **kwargs):
        vp = vs * 1.23 + 1.28
        return (vp, 0.541 + 0.3601 * vp, _lane_fill(vs, 80.0),
                _lane_fill(vs, 160.0))


class OceanCrust(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanCrust", "Group": "crust"})

    def _nFineLayers(self, **kwargs):
        return min(max(int(round(float(self._calH(**kwargs)) / 2)), 2), 10)

    def _calVs(self, z, **kwargs):
        v = self.parm["Vs"]
        ref = kwargs.get("lanes")
        if ref is not None:
            if isinstance(v, (list, tuple)):
                v0, v1 = _col(v[0], ref), _col(v[1], ref)
                return v0 + (v1 - v0) * _lin01(z.shape[1], ref)
            return _col(v, ref) * torch.ones_like(z)
        if isinstance(v, (list, tuple)):
            v0, v1 = float(v[0]), float(v[1])
            return v0 + (v1 - v0) * _linspace01(len(z))
        return float(v) * torch.ones(len(z), dtype=_F64)

    def _calOthers(self, z, vs, **kwargs):
        vp = vs * 1.8
        return (vp, 0.541 + 0.3601 * vp, _lane_fill(vs, 350.0),
                _lane_fill(vs, 1400.0))


class OceanMantle(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanMantle", "Group": "mantle"})

    def _nFineLayers(self, **kwargs):
        return self._adaptiveN(float(self._calH(**kwargs)))

    def _calVs(self, z, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            return _spline_lanes(self.parm["Vs"], _basis_lanes(
                z.shape[1], len(self.parm["Vs"]),
                self.parm.get("deg", None), ref), ref)
        coef = _vec([float(v) for v in self.parm["Vs"]])
        basis = self._bspl(len(z), len(self.parm["Vs"]),
                           self.parm.get("deg", None))
        return coef @ basis

    def _calOthers(self, z, vs, **kwargs):
        return (vs * 1.76, 3.4268 + (vs - 4.5) / 4.5,
                _lane_fill(vs, 150.0), _lane_fill(vs, 1400.0))


class ReferenceMantle(OceanMantle):
    """Linear-slope extension below the inverted stack (layers.py:267-284)."""

    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "ReferenceMantle", "Group": "mantle"})

    def _nFineLayers(self, **kwargs):
        return 20

    def _calVs(self, z, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            vs0 = kwargs["layersAbove"][1][:, None]
            return (vs0 + (z[:, -1:] - z[:, :1]) * _col(self.parm["Slope"], ref)
                    * _lin01(z.shape[1], ref))
        vs0 = float(kwargs["layersAbove"][1][-1])
        return (vs0 + float(z[-1] - z[0]) * float(self.parm["Slope"])
                * _linspace01(len(z)))

    def _calOthers(self, z, vs, **kwargs):
        vp, rho, qs, qp = super()._calOthers(z, vs, **kwargs)
        la = kwargs["layersAbove"]
        if kwargs.get("lanes") is not None:
            return tuple(a[:, None] + (x - x[:, :1])
                         for a, x in zip(la[2:6], (vp, rho, qs, qp)))
        vp = float(la[2][-1]) + (vp - vp[0])
        rho = float(la[3][-1]) + (rho - rho[0])
        qs = float(la[4][-1]) + (qs - qs[0])
        qp = float(la[5][-1]) + (qp - qp[0])
        return vp, rho, qs, qp


class OceanSedimentCascadia(OceanSediment):
    """H -> Vs empirical sediment (layers.py:289-295)."""

    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanSedimentCascadia",
                          "Group": "sediment"})

    def _calVs(self, z, **kwargs):
        ref = kwargs.get("lanes")
        if ref is not None:
            H = self._calH_lanes(ref, **kwargs)
            vs = (0.02 * H**2 + 1.27 * H + 0.29 * 0.1) / (H + 0.29)
            return vs * torch.ones_like(z)
        H = float(self._calH(**kwargs))
        vs = (0.02 * H**2 + 1.27 * H + 0.29 * 0.1) / (H + 0.29)
        return vs * torch.ones(len(z), dtype=_F64)


class OceanMantleHybrid(OceanMantle):
    """Thermal (HSCM->Vs) profile + B-spline perturbation, spline-merged
    across the melt-onset depth (layers.py:297-363)."""

    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanMantleHybrid", "Group": "mantle"})

    @staticmethod
    def _crust_thickness(layersAbove):
        z, grp = np.asarray(layersAbove[0]), np.asarray(layersAbove[6])
        h = np.diff(z)
        if len(grp) == len(z):  # grid-aligned lists (models.py:75-84)
            grp = grp[:-1]
        # else: context carries a seed z entry, grp already h-aligned
        keep = h > 0.01
        return float(np.sum(h[keep][grp[keep] == "crust"]))

    @staticmethod
    def _melt_onset(age, Tp=1325.0):
        """Depth where T first exceeds 0.92x the damp solidus."""
        from pysurfinv_tpu_torch.models.thermal import HSCM, solidus
        therm = HSCM(age=age, Tp=Tp)
        sol = solidus(therm.P, "Ruan2018")
        hot = therm.T > 0.92 * sol
        if not bool(hot.any()):
            return therm.zdeps[-1]
        return therm.zdeps[int(torch.argmax(hot.to(torch.int8)))]

    @staticmethod
    def _melt_onset_lanes(age, Tp=1325.0):
        """:meth:`_melt_onset` per lane: ``age`` (N, 1) -> (N,), on the
        JAX package's 200-node grid (numpy's linspace rounding)."""
        from pysurfinv_tpu_torch.models.thermal import HSCM, solidus
        zdeps = device_constant("melt_zdeps", lambda: np.linspace(0.0, 200.0,
                                                                  200),
                                age.dtype, age.device)
        therm = HSCM(age=age, zdeps=zdeps, Tp=Tp)
        hot = therm.T > 0.92 * solidus(therm.P, "Ruan2018")
        first = zdeps[torch.argmax(hot.to(torch.int8), dim=1)]
        return torch.where(hot.any(dim=1), first, zdeps[-1])

    def _calVs(self, z, **kwargs):
        from pysurfinv_tpu_torch.models.thermal import (HSCM, OceanSeisRitz,
                                                        OceanSeisRuan)
        if kwargs.get("lanes") is not None:
            return self._calVs_lanes(z, **kwargs)
        layersAbove = kwargs["layersAbove"]
        crustH = kwargs.get("crustH")
        if crustH is None:
            crustH = self._crust_thickness(layersAbove)
        n_basis = len(self.parm["Vs"]) + 1
        Tp = self.parm.get("Tp", 1325)
        age = torch.clamp(_vec(float(self.parm["ThermAge"])), min=1e-3)

        conv = self.parm.get("Conversion", "Ritzwoller")
        therm = HSCM(age=age, zdeps=crustH + z, Tp=Tp)
        if conv == "Yamauchi":
            seis = OceanSeisRuan(therm, period=1)
        elif conv == "Ritzwoller":
            seis = OceanSeisRitz(therm)
        else:
            raise ValueError(f"Invalid conversion model: {conv}")

        z_melt = self._melt_onset(age, Tp=Tp) - crustH
        coef = _vec([0.0] + [float(v) for v in self.parm["Vs"]])
        basis = self._bspl(len(z), n_basis)
        vs_pert = coef @ basis + seis.vs
        xL = z_melt
        xH = (z_melt + crustH) * 1.7 - crustH
        self._debug_zMelt = z_melt
        return self._merge(z, seis.vs, vs_pert, xL, xH)

    def _calVs_lanes(self, z, **kwargs):
        """Lane mode of :meth:`_calVs`: ``crustH`` (N,) comes from the
        caller (the compiled model accumulates it), the merge is the
        Hermite bridge."""
        from pysurfinv_tpu_torch.models.thermal import (HSCM, OceanSeisRitz,
                                                        OceanSeisRuan)
        ref = kwargs["lanes"]
        crustH = kwargs["crustH"][:, None]
        Tp = self.parm.get("Tp", 1325)
        age = torch.clamp(_col(self.parm["ThermAge"], ref), min=1e-3)
        conv = self.parm.get("Conversion", "Ritzwoller")
        therm = HSCM(age=age, zdeps=crustH + z, Tp=Tp)
        if conv == "Yamauchi":
            seis = OceanSeisRuan(therm, period=1)
        elif conv == "Ritzwoller":
            seis = OceanSeisRitz(therm)
        else:
            raise ValueError(f"Invalid conversion model: {conv}")
        z_melt = self._melt_onset_lanes(age, Tp=Tp)[:, None] - crustH
        basis = _basis_lanes(z.shape[1], len(self.parm["Vs"]) + 1, None, ref)
        vs_pert = _spline_lanes([0.0] + list(self.parm["Vs"]), basis,
                                ref) + seis.vs
        xH = (z_melt + crustH) * 1.7 - crustH
        return self._merge_lanes(z, seis.vs, vs_pert, z_melt, xH)

    @staticmethod
    def _merge_lanes(z, y1, y2, xL, xH):
        """Lane-mode bridge (the JAX package's traced ``_merge``): a
        cubic Hermite between the last kept points of y1 and y2 with
        finite-difference end slopes, which agrees with the reference's
        global CubicSpline to within the fine-grid discretization.
        z, y1, y2 (N, n); xL, xH (N, 1)."""
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
        h00 = 2 * s**3 - 3 * s**2 + 1
        h10 = s**3 - 2 * s**2 + s
        h01 = -2 * s**3 + 3 * s**2
        h11 = s**3 - s**2
        bridge = h00 * yL + h10 * span * sL + h01 * yH + h11 * span * sH
        return torch.where(z < zL, y1, torch.where(z > zH, y2, bridge))

    @staticmethod
    def _merge(z, y1, y2, xL, xH):
        """Smooth bridge: y1 for z < xL, y2 for z > xH, through scipy's
        CubicSpline on the retained points (exactly layers.py:320-324)."""
        from scipy.interpolate import CubicSpline
        z_, y1_, y2_ = (np.asarray(z), np.asarray(y1), np.asarray(y2))
        xL, xH = float(xL), float(xH)
        xs = list(z_[z_ < xL]) + list(z_[z_ > xH])
        ys = list(y1_[z_ < xL]) + list(y2_[z_ > xH])
        return _vec(CubicSpline(xs, ys)(z_))

    def _calOthers(self, z, vs, **kwargs):
        from pysurfinv_tpu_torch.models.thermal import HSCM, OceanSeisRuan
        modelInfo = kwargs.get("modelInfo", {})
        layersAbove = kwargs["layersAbove"]
        Qage = (modelInfo.get("lithoAge", None)
                if modelInfo.get("lithoAgeQ", False) else None)
        period = modelInfo.get("period", 1)
        Qage = self.parm["ThermAge"] if Qage is None else Qage
        ref = kwargs.get("lanes")
        if ref is not None:
            z0 = layersAbove[0][:, None]
            age = torch.clamp(_col(Qage, ref), min=1e-3)
        else:
            z0 = float(layersAbove[0][-1])
            age = torch.clamp(_vec(float(Qage)), min=1e-3)
        seis = OceanSeisRuan(HSCM(age=age, zdeps=z0 + z), period=period)
        vp, rho, qs, qp = super()._calOthers(z, vs, **kwargs)
        qs = torch.clamp(seis.qs, max=5000.0)
        return vp, rho, qs, qp


layerClassDict = {
    "PureLayer": PureLayer,
    "PureGrid": PureGrid,
    "Sediment": Sediment,
    "Crust": Crust,
    "Mantle": OceanMantle,
    "OceanWater": OceanWater,
    "OceanSediment": OceanSediment,
    "OceanCrust": OceanCrust,
    "OceanMantle": OceanMantle,
    "ReferenceMantle": ReferenceMantle,
    "OceanSedimentCascadia": OceanSedimentCascadia,
    "OceanMantleHybrid": OceanMantleHybrid,
    # LayerName aliases: Model1D.toYML keys sections by prop["LayerName"]
    # (models.py:66), which for the land classes differs from the class
    # key above — without these, a saved land-model setting cannot be
    # reloaded.  The reference's layerClassDict (layers.py:553-570) has
    # the same gap.
    "LandSediment": Sediment,
    "LandCrust": Crust,
}


def _isNumeric(v):
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def buildSeisLayer(parm: dict, layerClass, BrownianConvert=True) -> SeisLayer:
    """YAML parameter lists -> Brownian variables (layers.py:573-604).

    ``[v, 'fixed'|'total']`` stays a constant; ``[v, 'abs'|'abs_pos'|
    'rel'|'rel_pos', width, step]`` becomes a BrownianVarMC;
    ``[v, vmin, vmax, step]`` becomes a plain BrownianVar.
    """
    if BrownianConvert:
        def isBrownian(v):
            if type(v) is list and len(v) >= 2:
                if v[1] in ("fixed", "total", "abs", "abs_pos", "rel",
                            "rel_pos"):
                    return True
                if len(v) == 4 and _isNumeric(v[1]):
                    return True
            return False

        def toBrownian(v):
            if v[1] in ("fixed", "total"):
                return v[0]
            if v[1] in ("abs", "abs_pos", "rel", "rel_pos"):
                return BrownianVarMC(v[0], ref=v[0], type=v[1], width=v[2],
                                     step=v[3])
            return BrownianVar(v[0], v[1], v[2], v[3])

        parm = _dictIterModifier(parm, isBrownian, toBrownian)
    return layerClass(parm)

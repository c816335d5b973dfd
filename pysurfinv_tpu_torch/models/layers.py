"""Seismic layer catalog: parameters -> fine grids of (z, vs, vp, rho, qs, qp).

Capability spec from the reference pySurfInv's ``layers.py``.  Every
concrete layer type reproduces the reference's parameterization and
empirical rock-property relations (vp/rho/qs/qp from vs).  This is the
host mode of the JAX package's layer classes: ``parm`` holds plain
floats, grids are float64 CPU tensors, fine-layer counts are adaptive
exactly as in the reference, and the melt-onset merge of the hybrid
thermal layer uses scipy's CubicSpline.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from pysurfinv_tpu_torch.models.bspline import bspline_basis
from pysurfinv_tpu_torch.models.brownian import BrownianVar, BrownianVarMC
from pysurfinv_tpu_torch.utils import _dictIterModifier

_F64 = torch.float64


def _vec(x):
    return torch.as_tensor(x, dtype=_F64)


def _linspace01(n):
    return torch.linspace(0.0, 1.0, n, dtype=_F64)


def _full(n, v):
    return torch.full((n,), v, dtype=_F64)


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


class PureLayer(SeisLayer):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "PureLayer"})

    def seisPropLayers(self, **kwargs):
        p = self.parm
        return tuple(_vec(p[k]) for k in ("h", "vs", "vp", "rho", "qs", "qp"))

    def H(self, **kwargs):
        return _vec(self.parm["h"]).sum()


class PureGrid(SeisLayer):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "PureGrid"})

    def seisPropGrids(self, **kwargs):
        p = self.parm
        return tuple(_vec(p[k]) for k in ("z", "vs", "vp", "rho", "qs", "qp"))

    def H(self, **kwargs):
        z = _vec(self.parm["z"])
        return z[-1] - z[0]


class SeisLayerVs(SeisLayer):
    """Template: H + Vs parameterization, empirical others (layers.py:109)."""

    def seisPropGrids(self, **kwargs):
        N = kwargs.get("nFine") or self._nFineLayers(**kwargs)
        H = float(self._calH(**kwargs))
        z = _linspace01(N + 1) * H
        vs = self._calVs(z, **kwargs)
        vp, rho, qs, qp = self._calOthers(z, vs, **kwargs)
        return z, vs, vp, rho, qs, qp

    def _calH(self, **kwargs):
        if "BottomDepth" in self.parm:
            z0 = kwargs["layersAbove"][0][-1]
            return self.parm["BottomDepth"] - z0
        return self.parm["H"]

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
        if isinstance(v, (list, tuple)):
            return torch.linspace(float(v[0]), float(v[1]), len(z),
                                  dtype=_F64)
        return _full(len(z), float(v))

    def _calOthers(self, z, vs, **kwargs):
        n = len(z)
        return vs * 2.0, _brocher_rho(vs), _full(n, 80.0), _full(n, 160.0)


class Crust(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "LandCrust", "Group": "crust"})

    def _nFineLayers(self, **kwargs):
        return self._adaptiveN(float(self._calH(**kwargs)))

    def _calVs(self, z, **kwargs):
        coef = _vec([float(v) for v in self.parm["Vs"]])
        basis = self._bspl(len(z), len(self.parm["Vs"]))
        vs = coef @ basis
        gauss = self.parm.get("Gauss", False)
        if gauss is not False:
            A, mu, sig = (float(x) for x in gauss)
            vs = vs + A * torch.exp(-0.5 * ((z - mu) / sig) ** 2)
        return vs

    def _calOthers(self, z, vs, **kwargs):
        n = len(z)
        return (vs * 1.80, _brocher_rho(vs), _full(n, 600.0),
                _full(n, 1400.0))


class OceanWater(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanWater", "Group": "water"})
        self.parm["Vs"] = 0

    def seisPropGrids(self, **kwargs):
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
        return float(self.parm["Vs"]) * torch.ones(len(z), dtype=_F64)

    def _calOthers(self, z, vs, **kwargs):
        n = len(z)
        vp = vs * 1.23 + 1.28
        return vp, 0.541 + 0.3601 * vp, _full(n, 80.0), _full(n, 160.0)


class OceanCrust(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanCrust", "Group": "crust"})

    def _nFineLayers(self, **kwargs):
        return min(max(int(round(float(self._calH(**kwargs)) / 2)), 2), 10)

    def _calVs(self, z, **kwargs):
        v = self.parm["Vs"]
        if isinstance(v, (list, tuple)):
            v0, v1 = float(v[0]), float(v[1])
            return v0 + (v1 - v0) * _linspace01(len(z))
        return float(v) * torch.ones(len(z), dtype=_F64)

    def _calOthers(self, z, vs, **kwargs):
        n = len(z)
        vp = vs * 1.8
        return vp, 0.541 + 0.3601 * vp, _full(n, 350.0), _full(n, 1400.0)


class OceanMantle(SeisLayerVs):
    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "OceanMantle", "Group": "mantle"})

    def _nFineLayers(self, **kwargs):
        return self._adaptiveN(float(self._calH(**kwargs)))

    def _calVs(self, z, **kwargs):
        coef = _vec([float(v) for v in self.parm["Vs"]])
        basis = self._bspl(len(z), len(self.parm["Vs"]),
                           self.parm.get("deg", None))
        return coef @ basis

    def _calOthers(self, z, vs, **kwargs):
        n = len(z)
        return (vs * 1.76, 3.4268 + (vs - 4.5) / 4.5,
                _full(n, 150.0), _full(n, 1400.0))


class ReferenceMantle(OceanMantle):
    """Linear-slope extension below the inverted stack (layers.py:267-284)."""

    def __init__(self, parm=None, prop=None):
        super().__init__(parm, prop)
        self.prop.update({"LayerName": "ReferenceMantle", "Group": "mantle"})

    def _nFineLayers(self, **kwargs):
        return 20

    def _calVs(self, z, **kwargs):
        vs0 = float(kwargs["layersAbove"][1][-1])
        return (vs0 + float(z[-1] - z[0]) * float(self.parm["Slope"])
                * _linspace01(len(z)))

    def _calOthers(self, z, vs, **kwargs):
        vp, rho, qs, qp = super()._calOthers(z, vs, **kwargs)
        la = kwargs["layersAbove"]
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

    def _calVs(self, z, **kwargs):
        from pysurfinv_tpu_torch.models.thermal import (HSCM, OceanSeisRitz,
                                                        OceanSeisRuan)
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
        z0 = float(layersAbove[0][-1])
        period = modelInfo.get("period", 1)
        Qage = self.parm["ThermAge"] if Qage is None else Qage
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

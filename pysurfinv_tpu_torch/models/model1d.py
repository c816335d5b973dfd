"""1-D model assembly and the Cascadia region classes.

Capability spec from the reference pySurfInv's ``models.py``: layer
stacking with ``layersAbove`` context and topography offset, YAML
round-trip with Brownian parameter lists, thin-layer filtering and
padding for the solver, the forward dispersion call (the port's
single-model ``surf_forward`` in place of the f2py fast_surf), and the
Cascadia region classes with localInfo injection.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np
import torch

from pysurfinv_tpu_torch.models.brownian import BrownianVar
from pysurfinv_tpu_torch.models.layers import (
    buildSeisLayer, layerClassDict as layerClassDefault)
from pysurfinv_tpu_torch.utils import _dictIterModifier, plotGrid, plotLayer

EPS = np.finfo(float).eps


def monoIncrease(a, eps=EPS):
    return np.all(np.diff(a) >= eps)


def monoNonDecrease(a, tol=1e-12):
    """Non-strict monotonicity (the physical intent of the reference's
    CascadiaOcean.isgood sediment check, models.py:591)."""
    return np.all(np.diff(a) >= -tol)


def _pad_len(n, align=8):
    return int(-(-n // align) * align)


def padded_profile(h, vs, vp, rho, qs, L=None):
    """Pad a layered profile for the solver: halfspace replicated, h=0.

    Mirrors the fast_surf call conventions (models.py:11-27): thin layers
    (h <= 1e-3) dropped, qsinv = 1/qs, the last layer acts as halfspace.
    """
    h, vs, vp, rho, qs = map(np.asarray, (h, vs, vp, rho, qs))
    keep = h > 1e-3
    h, vs, vp, rho, qs = h[keep], vs[keep], vp[keep], rho[keep], qs[keep]
    nlay = len(h)
    L = _pad_len(nlay) if L is None else L
    pad = L - nlay

    def p(x, fill):
        return np.concatenate([x, np.full(pad, fill)])

    return (p(h, 0.0), p(vp, vp[-1]), p(vs, vs[-1]), p(rho, rho[-1]),
            p(1.0 / qs, 1.0 / qs[-1]), nlay)


def calForward(inProfile, wavetype="Ray", periods=(5, 10, 20, 40, 60, 80),
               device="cuda", dtype=torch.float64):
    """Drop-in equivalent of the reference's ``_calForward``
    (models.py:11-33): (6, n) profile -> phase velocities (numpy), or
    None when any period failed (c < 0.01).  Solves on ``device`` in
    ``dtype``."""
    from pysurfinv_tpu_torch.ops.dispersion import SurfConfig, surf_forward

    wave = {"Ray": "rayleigh", "Love": "love"}.get(wavetype)
    if wave is None:
        raise ValueError(f"Wrong surface wave type: {wavetype}!")
    prof = np.asarray(inProfile, dtype=float)
    H, VP, VS, RHO, QSI, nlay = padded_profile(
        prof[0], prof[1], prof[2], prof[3], prof[4])
    t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa
    c, u, ok = surf_forward(t(H), t(VP), t(VS), t(RHO), t(QSI),
                            t(np.asarray(periods, dtype=float)), nlay,
                            wave=wave, cfg=SurfConfig())
    c = c[:, 0].cpu().numpy()
    if np.any(c < 0.01):
        return None
    return c


class Model1D:
    """Stack of SeisLayers + Info dict (models.py:36-187)."""

    def __init__(self, layers=None, info=None):
        self._layers = layers or []
        self.info = info

    # ---- settings I/O ---------------------------------------------------
    def loadYML(self, ymlFile, localInfo=None, layerClassCustom=None):
        layerClassDict = dict(layerClassDefault)
        layerClassDict.update(layerClassCustom or {})
        if type(ymlFile) is not dict:
            import yaml
            with open(ymlFile) as f:
                ymlFile = yaml.load(f, Loader=yaml.FullLoader)
        ymlDict = deepcopy(ymlFile)
        self.info = ymlDict.pop("Info")
        localDict = self._loadLocalInfo(ymlDict, localInfo or {},
                                        layerClassDict)
        self._layers = [buildSeisLayer(parm, layerClassDict[tid])
                        for tid, parm in localDict.items()]

    def _loadLocalInfo(self, ymlDict, localInfo, layerClassDict):
        self.info.update(localInfo)
        return ymlDict

    def toYML(self):
        def modifier(v):
            return [v.v, v.vmin, v.vmax, v.step]

        ymlDict = {}
        for layer in self.layers:
            ymlDict[layer.prop["LayerName"]] = _dictIterModifier(
                layer.parm, lambda v: isinstance(v, BrownianVar), modifier)
        ymlDict["Info"] = self.info
        return deepcopy(ymlDict)

    # ---- structure ------------------------------------------------------
    def seisPropGrids(self, refLayer=False, _layerName=False,
                      hLowerLimit=0.01):
        layers = list(self.layers) + ([self._refLayer] if refLayer else [])
        z0 = -max(self.info.get("topo", 0) or 0, 0)
        z, vs, vp, rho, qs, qp = [], [], [], [], [], []
        grp, layerName = [], []
        for layer in layers:
            out = layer.seisPropGrids(
                layersAbove=[z, vs, vp, rho, qs, qp, grp, layerName],
                modelInfo=self.info)
            z1, vs1, vp1, rho1, qs1, qp1 = [np.asarray(x) for x in out]
            if z1[-1] - z1[0] < hLowerLimit:
                continue
            z += list(z1 + z0)
            vs += list(vs1)
            vp += list(vp1)
            rho += list(rho1)
            qs += list(qs1)
            qp += list(qp1)
            grp += [layer.prop["Group"]] * len(z1)
            layerName += [layer.prop["LayerName"]] * len(z1)
            z0 = z[-1]
        arrs = tuple(np.array(x) for x in (z, vs, vp, rho, qs, qp))
        if _layerName:
            return (*arrs, grp, layerName)
        return (*arrs, grp)

    def seisPropLayers(self, refLayer=False):
        z, vs, vp, rho, qs, qp, grp = self.seisPropGrids(refLayer)
        h = np.diff(z)
        mid = lambda x: (x[1:] + x[:-1]) / 2  # noqa: E731
        vs, vp, rho, qs, qp = mid(vs), mid(vp), mid(rho), mid(qs), mid(qp)
        grp = grp[:-1]
        keep = h > 0.01
        return (h[keep], vs[keep], vp[keep], rho[keep], qs[keep], qp[keep],
                list(np.array(grp)[keep]))

    def value(self, zdeps, type="vs"):
        if type != "vs":
            raise ValueError("Error: only support vs, others to be added...")
        z, vs, *_ = self.seisPropGrids()
        return np.interp(zdeps, z, vs, left=np.nan, right=np.nan)

    def moho(self):
        z, *_, grp = self.seisPropGrids()
        return z[grp.index("mantle")]

    # ---- prediction -----------------------------------------------------
    def forward(self, periods=(5, 10, 20, 40, 60, 80), device="cuda",
                dtype=torch.float64):
        """Rayleigh phase velocities at ``periods`` (models.py:104-112),
        solved on ``device`` in ``dtype``; None, after
        printing the model, when the forward failed."""
        refLayer = self.info.get("refLayer", False)
        prof = np.array(self.seisPropLayers(refLayer=refLayer)[:-1])
        pred = calForward(prof, wavetype="Ray", periods=periods,
                          device=device, dtype=dtype)
        if pred is None:
            print("Warning: Forward not complete! Model listed below:")
            self.show()
        return pred

    # ---- presentation ----------------------------------------------------
    def show(self):
        for layer in self.layers:
            print(layer.prop["Group"])
            print(layer.parm)

    def plotProfile(self, type="vs", **kwargs):
        h, vs, *_ = self.seisPropLayers()
        return plotLayer(h, vs, **kwargs)

    def plotProfileGrid(self, type="vs", ax=None, **kwargs):
        z, vs, *_ = self.seisPropGrids(refLayer=False)
        return plotGrid(z, vs, ax=ax, **kwargs)

    # ---- misc -------------------------------------------------------------
    def _getLayer(self, layerName):
        try:
            ind = [l.prop["LayerName"] for l in self._layers].index(layerName)
            return self._layers[ind]
        except ValueError:
            return None

    @property
    def _refLayer(self):
        return buildSeisLayer({"H": 300, "Slope": 0.35 / 200},
                              layerClassDefault["ReferenceMantle"])

    @property
    def layers(self):
        return self._layers

    def copy(self):
        return deepcopy(self)


class PureGird(Model1D):
    """Grid-profile model re-wrapped from smoothed 3-D products
    (models.py:163-184; name kept for reference compatibility):
    ``inProfiles`` is (z, vs, vp, rho, qs, qp, groups) on one node grid,
    split into one ``PureGrid`` layer per group, each group's z starting
    at 0."""

    def __init__(self, inProfiles, info=None):
        from pysurfinv_tpu_torch.models.layers import PureGrid
        parm = {}
        (parm["z"], parm["vs"], parm["vp"], parm["rho"], parm["qs"],
         parm["qp"], grps) = inProfiles
        self._layers = []
        for grp in list(dict.fromkeys(grps)):
            I = np.array(grps) == grp
            parmLayer = {}
            for k, v in parm.items():
                parmLayer[k] = np.asarray(v)[I]
                if k == "z":
                    parmLayer[k] = parmLayer[k] - parmLayer[k][0]
            self._layers.append(PureGrid(parmLayer, prop={"Group": grp}))
        self.info = info

    def loadYML(self, *a, **k):
        raise AttributeError('"PureGird" object has no method "loadYML"')


PureGrid1D = PureGird  # non-typo alias


class MCinv(Model1D):
    """MC-invertible model: perturb/reset + prior hooks (models.py:190)."""

    def perturb(self, isgood=None, verbose=False):
        if isgood is None:
            isgood = lambda m: m.isgood()  # noqa: E731
        for i in range(1000):
            newModel = self.copy()
            newModel._layers = [l._perturb() for l in self.layers]
            if isgood(newModel):
                return newModel
        return self.reset(isgood=isgood, verbose=verbose)

    def reset(self, isgood=None, verbose=False):
        if isgood is None:
            isgood = lambda m: m.isgood()  # noqa: E731
        for i in range(10000):
            newModel = self.copy()
            newModel._layers = [l._reset() for l in self.layers]
            if isgood(newModel):
                return newModel
        raise RuntimeError(
            "Error: Could not find a good model through reset.")

    def isgood(self):
        return True

    def _loadMC(self, mc):
        mc_ind = 0
        for layer in self.layers:
            for k, v in layer.parm.items():
                if isinstance(v, BrownianVar):
                    layer.parm[k] = v._setValue(mc[mc_ind])
                    mc_ind += 1
                elif type(v) == list:
                    for i in range(len(v)):
                        if isinstance(v[i], BrownianVar):
                            v[i] = v[i]._setValue(mc[mc_ind])
                            mc_ind += 1
                    layer.parm[k] = v

    def _brownians(self, numberOnly=True):
        out = []
        for layer in self.layers:
            for k, v in layer.parm.items():
                if type(v) is list:
                    for e in v:
                        if isinstance(e, BrownianVar):
                            out.append([e, layer.prop["Group"], k])
                elif isinstance(v, BrownianVar):
                    out.append([v, layer.prop["Group"], k])
        if numberOnly:
            out = [float(v[0]) for v in out]
        return out

    def _dump(self, index, target, preInfo=None):
        preInfo = list(preInfo or [])
        preInfo.extend(self._brownians())
        target[index] = preInfo


def _set_or_scale(localDict, key, name, value):
    try:
        localDict[key][name][0] = value
    except (TypeError, KeyError, IndexError):
        localDict[key][name] = value


def _grp2layer(ymlDict, layerClassDict):
    grp2layer = {layerClassDict[t]().prop["Group"]: t for t in ymlDict}
    if len(ymlDict) != len(grp2layer):
        raise ValueError("Please check if repeated group exists!")
    return grp2layer


class CascadiaOcean(MCinv):
    """Juan de Fuca ocean-plate model (models.py:525-677)."""

    def _loadLocalInfo(self, ymlDict, localInfo, layerClassDict):
        ymlDict = super()._loadLocalInfo(ymlDict, localInfo, layerClassDict)
        localDict = deepcopy(ymlDict)
        grp2layer = _grp2layer(ymlDict, layerClassDict)

        topo = localInfo.get("topo", self.info.get("topo", 0))
        waterH = max(-topo, 0)
        if waterH > 0 and "water" in grp2layer:
            _set_or_scale(localDict, grp2layer["water"], "H", waterH)
        elif waterH == 0 and "water" in grp2layer:
            del localDict[grp2layer["water"]]

        if "sedthk" in localInfo:
            _set_or_scale(localDict, grp2layer["sediment"], "H",
                          localInfo["sedthk"])

        if "lithoAge" in localInfo:
            m = grp2layer["mantle"]
            try:
                localDict[m]["ThermAge"][0] = localInfo["lithoAge"]
                if (localDict[m]["ThermAge"][1] in ("rel_pos", "rel")
                        and localDict[m]["ThermAge"][0] < 2):
                    localDict[m]["ThermAge"][1] = "abs_pos"
                    localDict[m]["ThermAge"][2] = \
                        2 * localDict[m]["ThermAge"][2] / 100
            except (TypeError, KeyError):
                localDict[m]["ThermAge"] = localInfo["lithoAge"]

        if "mantleInitParmVs" in localInfo:
            for i, vs in enumerate(localInfo["mantleInitParmVs"]):
                try:
                    localDict[grp2layer["mantle"]]["Vs"][i][0] = vs
                except (TypeError, IndexError):
                    localDict[grp2layer["mantle"]]["Vs"][i] = vs
            self.info.pop("mantleInitParmVs")
        return localDict

    def isgood(self, verbose=False):
        z, vs, *_, grp = self.seisPropGrids(refLayer=False)
        grp = np.array(grp)
        vsS, vsC, vsM = vs[grp == "sediment"], vs[grp == "crust"], \
            vs[grp == "mantle"]
        zM = z[grp == "mantle"]

        if np.any(vsS < 0.2):                       # sediment Vs > 0.2
            return False
        for i in np.where(grp[1:] != grp[:-1])[0]:  # positive group jumps
            if vs[i + 1] < vs[i]:
                return False
        if not monoNonDecrease(vsS) or not monoNonDecrease(vsC):
            return False
        if (vs[-1] - vs[-2]) / (z[-1] - z[-2]) <= 0:  # increase at bottom
            return False

        # oscillation limit between adjacent local extrema (models.py:600)
        from pysurfinv_tpu_torch.inversion.priors import (
            _argrel, cwt_oscillation, local_extrema_oscillation)
        if not local_extrema_oscillation(vsM, 0.1 * vsM.mean()):
            return False
        # hybrid parameterization constraints (models.py:611-634)
        if _argrel(vsM, np.greater).size > 0:  # no local mantle maximum
            return False
        slope = np.diff(vsM) / np.diff(zM)
        if slope.min() < slope[0] * 1.5:
            return False
        return bool(cwt_oscillation(vsM, zM, limit=0.3))


class CascadiaPrism(MCinv):
    """Accretionary-prism model (models.py:260-360)."""

    def _loadLocalInfo(self, ymlDict, localInfo, layerClassDict):
        ymlDict = super()._loadLocalInfo(ymlDict, localInfo, layerClassDict)
        localDict = deepcopy(ymlDict)
        grp2layer = _grp2layer(ymlDict, layerClassDict)

        topo = localInfo.get("topo", self.info.get("topo", 0))
        waterH = max(-topo, 0)
        if waterH > 0 and "water" in grp2layer:
            _set_or_scale(localDict, grp2layer["water"], "H", waterH)
        elif waterH == 0 and "water" in grp2layer:
            del localDict[grp2layer["water"]]
        if "sedthk" in localInfo:
            _set_or_scale(localDict, grp2layer["sediment"], "H",
                          localInfo["sedthk"])
        if "prismthk" in localInfo:
            _set_or_scale(localDict, grp2layer["prism"], "H",
                          localInfo["prismthk"])
        return localDict

    def isgood(self, verbose=False):
        z, vs, *_, grp, layerName = self.seisPropGrids(_layerName=True)
        grp = np.array(grp)
        vsM = vs[grp == "mantle"]
        zM = z[grp == "mantle"]
        for i in np.where(grp[1:] != grp[:-1])[0]:
            if vs[i + 1] < vs[i]:
                return False
        if np.any(vs > 4.9):
            return False
        if not monoNonDecrease(vs[grp == "sediment"]):
            return False
        if not monoNonDecrease(vs[grp == "crust"]):
            return False
        if (vsM[-1] - vsM[-2]) / (zM[-1] - zM[-2]) <= 0:
            return False
        return True


class CascadiaContinent(MCinv):
    """Continental model (models.py:362-523)."""

    def _loadLocalInfo(self, ymlDict, localInfo, layerClassDict):
        ymlDict = super()._loadLocalInfo(ymlDict, localInfo, layerClassDict)
        localDict = deepcopy(ymlDict)
        grp2layer = _grp2layer(ymlDict, layerClassDict)
        if "sedthk" in localInfo:
            _set_or_scale(localDict, grp2layer["sediment"], "H",
                          localInfo["sedthk"])
        if "crsthk" in localInfo:
            _set_or_scale(localDict, grp2layer["crust"], "H",
                          localInfo["crsthk"])
        return localDict

    def isgood(self, verbose=False):
        z, vs, *_, grp, layerName = self.seisPropGrids(_layerName=True)
        grp = np.array(grp)
        for i in np.where(grp[1:] != grp[:-1])[0]:
            if vs[i + 1] < vs[i]:
                return False
        if np.any(vs > 4.9):
            return False
        if not monoNonDecrease(vs[grp == "sediment"]):
            return False
        if not monoNonDecrease(vs[grp == "crust"]):
            return False
        return True


modelTypeDict = {
    "General": Model1D,
    "MCInv": MCinv,
    "CascadiaOcean": CascadiaOcean,
    "CascadiaPrism": CascadiaPrism,
    "CascadiaContinent": CascadiaContinent,
}


def buildModel1D(ymlFile, localInfo=None, modelTypeCustom=None,
                 layerClassCustom=None) -> Model1D:
    """YAML (path or dict) -> Model1D subclass (models.py:681-704)."""
    if isinstance(ymlFile, dict):
        ymlDict = ymlFile
    else:
        import yaml
        with open(ymlFile) as f:
            ymlDict = yaml.load(f, Loader=yaml.FullLoader)
    if modelTypeCustom:
        mod = modelTypeCustom()
        mod.loadYML(ymlDict, localInfo or {}, layerClassCustom or {})
    else:
        cls = modelTypeDict[ymlDict["Info"].get("modelType", "General")]
        mod = cls()
        mod.loadYML(ymlDict, localInfo or {}, layerClassCustom or {})
    return mod

"""Model exchange containers — import/export surface to other tools.

Counterpart of the JAX package's ``geo/exchange.py`` (numpy; no device
work).  Capability spec from the reference's ``utils.py:133-277``:
``Model1D_Exchange`` (layer/grid 1-D profiles with interpolation and
plotting) and ``Model3D_Exchange`` (geographic grid of 1-D models with
bilinear interpolation, maps, sections, npz round-trip).
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

from pysurfinv_tpu_torch.geo.grid import GeoGrid, GeoMap, gc_direct, gc_inverse
from pysurfinv_tpu_torch.utils import plotGrid, plotLayer


class Model1D_Exchange:
    def __init__(self, parm, info=None):
        if "h" in parm:
            self.type = "layer"
        if "z" in parm:
            self.type = "grid"
        self.parm = deepcopy(parm)
        self.info = deepcopy(info or {})

    def propGrids(self, parName="vs"):
        if self.type == "grid":
            return self.parm["z"], self.parm[parName]
        h = np.asarray(self.parm["h"])
        z = np.zeros(2 * len(h)) + self.info.get("z0", 0)
        v = np.zeros(len(h) * 2)
        z[1::2] += h.cumsum()
        z[2::2] += h[:-1].cumsum()
        v[::2] = self.parm[parName][:]
        v[1::2] = self.parm[parName][:]
        return z, v

    def propLayers(self, parName="vs"):
        if self.type == "layer":
            return self.parm["h"], self.parm[parName]
        h = np.diff(self.parm["z"])
        v = (np.asarray(self.parm[parName])[1:]
             + np.asarray(self.parm[parName])[:-1]) / 2
        return h, v

    def value(self, zdeps, parName="vs"):
        z, v = self.propGrids(parName)
        return np.interp(zdeps, z, v, left=np.nan, right=np.nan)

    def plotLayers(self, parName="vs", ax=None, **kwargs):
        h, v = self.propLayers(parName)
        return plotLayer(h, v, ax=ax, **kwargs)

    def plotGrids(self, parName="vs", ax=None, **kwargs):
        z, v = self.propGrids(parName)
        return plotGrid(z, v, ax=ax, **kwargs)

    def copy(self):
        return deepcopy(self)


class Model3D_Exchange:
    def __init__(self, fname=None, lons=(), lats=()):
        if fname:
            self.load(fname)
        else:
            self.grid = GeoGrid(lons, lats)
            self.mods = [[None for _ in range(len(self.lons))]
                         for _ in range(len(self.lats))]

    @property
    def lons(self):
        return self.grid.lons

    @property
    def lats(self):
        return self.grid.lats

    def addMod(self, lon, lat, mod):
        i, j = self.grid._findInd(lon, lat)
        self.mods[i][j] = mod.copy()

    def getMod(self, lon, lat, parName, zdeps=None):
        def _zv(mod, zdeps):
            if zdeps is None:
                return mod.propGrids(parName)
            return zdeps, mod.value(zdeps, parName)

        ind = self.grid._findInd_linear_interp(lon, lat)
        if ind is None:
            return np.nan
        try:
            if len(ind) == 2:
                i, j = ind
                z, v = _zv(self.mods[i][j], zdeps)
                return Model1D_Exchange({"z": z, parName: v})
            i, j, dx, dy, Dx, Dy = ind
            z0, v0 = _zv(self.mods[i - 1][j - 1], zdeps)
            z1, v1 = _zv(self.mods[i][j - 1], zdeps)
            z2, v2 = _zv(self.mods[i - 1][j], zdeps)
            z3, v3 = _zv(self.mods[i][j], zdeps)
            z = (z0 + (z1 - z0) * dy / Dy + (z2 - z0) * dx / Dx
                 + (z0 + z3 - z1 - z2) * dx * dy / Dx / Dy)
            v = (v0 + (v1 - v0) * dy / Dy + (v2 - v0) * dx / Dx
                 + (v0 + v3 - v1 - v2) * dx * dy / Dx / Dy)
            return Model1D_Exchange({"z": z, parName: v})
        except (KeyError, AttributeError):
            return np.nan

    def getMap(self, z, parName):
        v = np.nan * np.ones((len(self.lats), len(self.lons)))
        for i in range(v.shape[0]):
            for j in range(v.shape[1]):
                if self.mods[i][j]:
                    v[i, j] = self.mods[i][j].value(z, parName)
        return GeoMap(self.lons, self.lats, v)

    def getSection(self, lat1, lon1, lat2, lon2, parName,
                   y=np.linspace(0, 200 - 0.01, 201), xtype="auto"):
        geo = gc_inverse(lat1, lon1, lat2, lon2)
        x = np.linspace(0, geo["s12"], 301) / 1000
        z = np.zeros((len(y), len(x)))
        for i, d in enumerate(x * 1000):
            p = gc_direct(lat1, lon1, geo["azi1"], d)
            mod = self.getMod(p["lon2"], p["lat2"], parName, y)
            z[:, i] = (mod.parm[parName] if isinstance(mod, Model1D_Exchange)
                       else np.nan)
        z = np.ma.masked_array(z, np.isnan(z))
        if xtype == "lat" or (xtype == "auto" and abs(lon1 - lon2) < 0.01):
            x = np.linspace(lat1, lat2, 301)
        elif xtype == "lon" or (xtype == "auto" and abs(lat1 - lat2) < 0.01):
            x = np.linspace(lon1, lon2, 301)
        XX, YY = np.meshgrid(x, y)
        return XX, YY, z

    def save(self, fname):
        m, n = len(self.mods), len(self.mods[0])
        mods = [[None for _ in range(n)] for _ in range(m)]
        for i in range(m):
            for j in range(n):
                mod = self.mods[i][j]
                mods[i][j] = mod if mod is None else [mod.parm, mod.info]
        np.savez_compressed(fname, model={"lons": self.lons,
                                          "lats": self.lats, "mods": mods})

    def load(self, fname):
        mod3D = np.load(fname, allow_pickle=True)["model"][()]
        lons, lats, mods = mod3D["lons"], mod3D["lats"], mod3D["mods"]
        self.grid = GeoGrid(lons, lats)
        m, n = len(mods), len(mods[0])
        self.mods = [[None for _ in range(n)] for _ in range(m)]
        for i in range(m):
            for j in range(n):
                mod = mods[i][j]
                self.mods[i][j] = (mod if mod is None
                                   else Model1D_Exchange(mod[0], mod[1]))

    def copy(self):
        return deepcopy(self)

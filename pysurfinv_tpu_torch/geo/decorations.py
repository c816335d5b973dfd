"""Cascadia section/map decorations — data-gated rebuilds.

Counterpart of the JAX package's ``geo/decorations.py`` (numpy and
matplotlib; no device work).  The reference ships these in ``utils.py:57-131`` (plotCascadiaSlab,
plotCascadiaTrenchCoast, plotVolcanos, plotMORLocation,
plotCascadiaSlab4Map) with hardcoded absolute paths to private local
datasets (Slab2 ``.grd`` files, ``prism.csv``, the PB2002 plate-boundary
GeoJSON) and a stack of heavyweight deps (netCDF4, shapely, geopandas,
basemap/geographiclib).  None of those files or libraries exist here, so
each function instead takes its dataset as an argument — a
:class:`~pysurfinv_tpu_torch.geo.grid.GeoMap`, an ``(N, 2)`` lon/lat
polyline array, or a text/npz path — and the geometry runs on this
repo's own primitives: spherical great circles (``geo/grid.py``:
``gc_inverse`` / ``gc_direct``) instead of geographiclib, and a
vectorized planar segment intersection instead of shapely (the
reference's shapely intersection is planar in lon/lat space
too, so the semantics match).

To hang one of these on ``Model3D.plotSection(decorateFuns=...)`` —
whose hooks are called as ``decorate(lon1, lat1, lon2, lat2)`` — bind
the data first::

    from functools import partial
    m3d.plotSection(lon1, lat1, lon2, lat2, decorateFuns=[
        partial(plotCascadiaSlab, slabDep=dep, slabThk=thk, slabDip=dip),
        partial(plotCascadiaTrenchCoast, prism="prism.csv"),
    ])
"""

from __future__ import annotations

import numpy as np

from .grid import GeoMap, gc_direct, gc_inverse


# ---------------------------------------------------------------- data


def _as_polyline(data):
    """``(N, 2)`` lon/lat vertices from an array or a delimited file."""
    if isinstance(data, (str, bytes)):
        pts = np.loadtxt(data, delimiter=",")
    else:
        pts = np.asarray(data, dtype=float)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError("polyline must be (N, 2) lon/lat vertices, "
                         f"got shape {pts.shape}")
    return pts


def _as_geomap(data):
    if isinstance(data, GeoMap):
        return data
    if isinstance(data, (str, bytes)):
        return geomap_from_file(data)
    raise TypeError("expected a GeoMap or a path to one "
                    f"(npz/netCDF3 grd), got {type(data).__name__}")


def geomap_from_file(path, lon_key=None, lat_key=None, z_key=None,
                     negate=False):
    """Load a gridded field into a :class:`GeoMap`.

    Supports ``.npz`` (keys default to lons/lats/z with x/y/z fallback)
    and classic netCDF-3 ``.grd`` via ``scipy.io`` when scipy is
    available.  Slab2 distributes netCDF-4/HDF5 grids, which need a one
    -off conversion (e.g. ``gmt grdconvert in.grd out.grd=cf`` or any
    xarray/netCDF4-equipped environment writing npz); the reference
    instead read them with the netCDF4 package (utils.py:57-62).
    """
    path = str(path)
    if path.endswith(".npz"):
        with np.load(path) as d:
            keys = set(d.keys())

            def pick(given, *cands):
                if given is not None:
                    return d[given]
                for c in cands:
                    if c in keys:
                        return d[c]
                raise KeyError(f"none of {cands} in {path} ({keys})")

            lons = pick(lon_key, "lons", "lon", "x")
            lats = pick(lat_key, "lats", "lat", "y")
            z = pick(z_key, "z", "dep", "data")
    else:
        try:
            from scipy.io import netcdf_file
        except ImportError as e:  # pragma: no cover - scipy is baked in
            raise ImportError(
                "reading .grd needs scipy (netCDF-3) — or convert to "
                ".npz with lons/lats/z arrays") from e
        with netcdf_file(path, mmap=False) as f:
            v = f.variables
            lons = v[lon_key or "x"][()].copy()
            lats = v[lat_key or "y"][()].copy()
            z = v[z_key or "z"][()].copy()
    return GeoMap(lons, lats, -np.asarray(z, float) if negate
                  else np.asarray(z, float))


# ------------------------------------------------------------ geometry


def segment_polyline_intersections(poly, p0, p1):
    """Intersections of segment ``p0->p1`` with a polyline, ``(K, 2)``.

    Planar lon/lat-space crossing test (the convention the reference
    inherits from shapely's ``LineString.intersection``), vectorized
    over all polyline edges; endpoint touches count once.
    """
    poly = np.asarray(poly, float)
    a, b = poly[:-1], poly[1:]            # (M, 2) edge endpoints
    c = np.asarray(p0, float)
    d = np.asarray(p1, float)
    e1 = b - a                            # edge direction
    e2 = d - c                            # query direction
    denom = e1[:, 0] * e2[1] - e1[:, 1] * e2[0]
    rel = c - a
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (rel[:, 0] * e2[1] - rel[:, 1] * e2[0]) / denom
        s = (rel[:, 0] * e1[:, 1] - rel[:, 1] * e1[:, 0]) / denom
    hit = (np.abs(denom) > 0) & (t >= 0) & (t <= 1) & (s >= 0) & (s <= 1)
    pts = a[hit] + t[hit, None] * e1[hit]
    if len(pts) > 1:                      # collapse duplicate vertex hits
        keep = np.ones(len(pts), bool)
        order = np.lexsort(pts.T)
        same = np.all(np.abs(np.diff(pts[order], axis=0)) < 1e-12, axis=1)
        keep[order[1:][same]] = False
        pts = pts[keep]
    return pts


def _norm180(lon):
    lon = np.asarray(lon, float)
    return lon - 360.0 * (lon > 180.0)


def _section_x(lon1, lat1, lon2, lat2, plon, plat):
    """Section x-coordinate of point(s) along the (lon1,lat1)-(lon2,lat2)
    line: latitude for meridional sections, longitude (0-360) for zonal
    ones, great-circle km otherwise (utils.py:92-101, 115-123)."""
    plon = np.atleast_1d(np.asarray(plon, float))
    plat = np.atleast_1d(np.asarray(plat, float))
    if abs(lon1 - lon2) < 0.01:
        x = plat
    elif abs(lat1 - lat2) < 0.01:
        x = plon + 360.0 * (plon < 0)
    else:
        x = np.array([gc_inverse(lat1, _norm180(lon1), la, lo)["s12"]
                      / 1000.0 for lo, la in zip(plon, plat)])
    return x if x.size > 1 else float(x[0])


def _gca(ax):
    import matplotlib.pyplot as plt
    return plt.gca() if ax is None else ax


# ---------------------------------------------------------- decorations


def plotCascadiaSlab(lon1, lat1, lon2, lat2, slabDep, slabThk, slabDip,
                     ax=None, n=301, color="w", lw=4):
    """Slab upper/lower surfaces along a section (utils.py:56-84).

    ``slabDep`` holds the slab-top depth (km, positive down — the
    reference negates Slab2's negative-down convention on load),
    ``slabThk`` the thickness (km), ``slabDip`` the dip (degrees).  The
    lower surface is the top displaced by the thickness along the local
    dip normal: ``(x - thk*sin(dip), dep + thk*cos(dip))``, exactly the
    reference construction; the only substitution is spherical
    great-circle sampling for WGS84 geodesics (<0.5 % in path length).
    """
    slabDep = _as_geomap(slabDep)
    slabThk = _as_geomap(slabThk)
    slabDip = _as_geomap(slabDip)
    ax = _gca(ax)

    geo = gc_inverse(lat1, lon1, lat2, lon2)
    x_km = np.linspace(0.0, geo["s12"], n) / 1000.0
    slabU, xslabD, slabD = [], [], []
    for d_km in x_km:
        p = gc_direct(lat1, lon1, geo["azi1"], d_km * 1000.0)
        lo, la = p["lon2"], p["lat2"]
        dep = slabDep.value(lo, la)
        theta = np.deg2rad(slabDip.value(lo, la))
        thk = slabThk.value(lo, la)
        slabU.append(dep)
        xslabD.append(d_km - thk * np.sin(theta))
        slabD.append(dep + thk * np.cos(theta))
    slabU, xslabD, slabD = map(np.asarray, (slabU, xslabD, slabD))

    # remap km -> the section's native x (lat / lon / km, utils.py:76-81)
    if abs(lon1 - lon2) < 0.01:
        xs = np.linspace(lat1, lat2, n)
        x, xslabD = xs, np.interp(xslabD, x_km, xs)
    elif abs(lat1 - lat2) < 0.01:
        xs = np.linspace(lon1, lon2, n)
        x, xslabD = xs, np.interp(xslabD, x_km, xs)
    else:
        x = x_km
    ax.plot(x, slabU, color, lw=lw)
    ax.plot(xslabD, slabD, color, lw=lw)
    return x, slabU, xslabD, slabD


def plotCascadiaTrenchCoast(lon1, lat1, lon2, lat2, prism, ax=None,
                            depth_extent=(0.0, 200.0)):
    """Dashed verticals where the section crosses the accretionary-prism
    outline (trench and coast sides), utils.py:86-102.

    ``prism`` is the outline polyline — an ``(N, 2)`` lon/lat array or a
    CSV path (the reference's ``prism.csv``), longitudes in [-180, 180].
    """
    ax = _gca(ax)
    poly = _as_polyline(prism)
    q0 = (_norm180(lon1), lat1)
    q1 = (_norm180(lon2), lat2)
    pts = segment_polyline_intersections(poly, q0, q1)
    if len(pts) == 0:
        return np.empty(0)
    xs = np.sort(np.atleast_1d(
        _section_x(lon1, lat1, lon2, lat2, pts[:, 0], pts[:, 1])))
    for x in xs:
        ax.plot([x, x], list(depth_extent), "--", c="r", lw=0.5)
    return xs


def plotVolcanos(lon1, lat1, lon2, lat2, volcanos=None, ax=None,
                 max_offset_km=50.0):
    """Volcano markers projected onto the section.

    The reference's body is literally ``pass`` (utils.py:104-105); this
    is the functional version it stubs: given volcano lon/lats, plot a
    surface triangle for each one within ``max_offset_km`` of the
    section's great circle.  With no data it is the same no-op.
    """
    if volcanos is None:
        return np.empty(0)
    ax = _gca(ax)
    pts = _as_polyline(volcanos)
    geo = gc_inverse(lat1, lon1, lat2, lon2)
    xs = []
    for lo, la in pts:
        g = gc_inverse(lat1, lon1, la, lo)
        along = g["s12"] / 1000.0
        # cross-track distance on the sphere
        dpsi = np.deg2rad(np.abs(g["azi1"] - geo["azi1"]))
        cross = abs(np.arcsin(np.sin(g["s12"] / 1000.0 / 6371.0)
                              * np.sin(dpsi))) * 6371.0
        if cross > max_offset_km or not (0 <= along * 1000.0
                                         <= geo["s12"]):
            continue
        p = gc_direct(lat1, lon1, geo["azi1"], along * 1000.0)
        xs.append(_section_x(lon1, lat1, lon2, lat2,
                             p["lon2"], p["lat2"]))
    xs = np.asarray(xs, float)
    for x in xs:
        ax.plot(x, 0, "^", markersize=8, markerfacecolor="k",
                clip_on=False, zorder=100)
    return xs


def plotMORLocation(lon1, lat1, lon2, lat2, boundary, ax=None):
    """Red triangle where the section crosses the ridge (utils.py:107-123).

    ``boundary`` is the plate-boundary polyline (the reference extracts
    the 'PA-JF' LineString from the PB2002 GeoJSON) as an ``(N, 2)``
    lon/lat array or text path, longitudes in [-180, 180].
    """
    ax = _gca(ax)
    poly = _as_polyline(boundary)
    pts = segment_polyline_intersections(
        poly, (_norm180(lon1), lat1), (_norm180(lon2), lat2))
    if len(pts) == 0:
        return None
    x = float(np.atleast_1d(_section_x(
        lon1, lat1, lon2, lat2, pts[0, 0], pts[0, 1]))[0])
    ax.plot(x, 0, "^", markersize=10, markerfacecolor="r",
            clip_on=False, zorder=100)
    return x


def plotCascadiaSlab4Map(ax, slabDep, levels=(60, 75, 90, 120, 150),
                         lon_shift=-360.0):
    """Labeled slab-depth contours on a map axes (utils.py:125-130).

    The reference draws on a basemap instance (``m.contour(latlon=True)``);
    here ``ax`` is any matplotlib axes in lon/lat coordinates (e.g. the
    one ``Model3D.plotMapView`` draws on).  ``lon_shift`` mirrors the
    reference's ``lons-360`` relabeling; pass 0 for 0-360 axes.
    """
    import matplotlib.pyplot as plt

    slabDep = _as_geomap(slabDep)
    XX, YY = np.meshgrid(slabDep.lons + lon_shift, slabDep.lats)
    cs = ax.contour(XX, YY, slabDep.z, levels=list(levels),
                    colors="white", linewidths=2)
    plt.clabel(cs, fontsize=9, inline=True, colors="k")
    return cs

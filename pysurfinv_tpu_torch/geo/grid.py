"""Geographic grids, maps, smoothing, and great-circle sampling.

Counterpart of the JAX package's ``geo/grid.py``.  Replaces the
reference's external ``Triforce.utils.GeoGrid/GeoMap`` dependency (used
throughout model3D.py) and the GMT ``surface`` subprocess smoothing
(``model3D.py:11-14``) with:

  * a minimal GeoGrid/GeoMap pair with the same access patterns
    (``_findInd``, ``_findInd_linear_interp``, ``XX/YY``, ``zMasked``);
  * NaN-aware Gaussian smoothing as separable ``conv1d`` passes over the
    whole (field, lat, lon) stack on the device — every (property,
    depth-node) map of a 3-D model in one batch;
  * spline-in-tension smoothing through an orthonormal DCT-II / DCT-III
    built on ``torch.fft``, also on the device;
  * spherical great-circle interpolation replacing geographiclib
    geodesics for cross-sections (WGS84 vs sphere differs by < 0.5 %
    in path length — visualization-grade, documented).

The smoothers take ``device=`` (default ``"cuda"``) and compute in
float64; they take and return numpy arrays.
"""

from __future__ import annotations

import numpy as np

EARTH_R_KM = 6371.0
DEG2KM = np.pi / 180.0 * EARTH_R_KM


class GeoGrid:
    def __init__(self, lons=(), lats=()):
        self.lons = np.asarray(lons, dtype=float)
        self.lats = np.asarray(lats, dtype=float)

    @property
    def XX(self):
        return np.meshgrid(self.lons, self.lats)[0]

    @property
    def YY(self):
        return np.meshgrid(self.lons, self.lats)[1]

    def _findInd(self, lon, lat):
        """(ilat, ilon) of the nearest grid node."""
        i = int(np.argmin(np.abs(self.lats - lat)))
        j = int(np.argmin(np.abs(self.lons - lon)))
        return i, j

    def _findInd_linear_interp(self, lon, lat):
        """Bilinear stencil (i, j, dx, dy, Dx, Dy) or exact (i, j)."""
        lon = lon + 360 * (lon < 0)
        if (lon - self.lons[0]) * (lon - self.lons[-1]) > 0:
            return None
        if (lat - self.lats[0]) * (lat - self.lats[-1]) > 0:
            return None
        j = int(np.where(self.lons - lon >= 0)[0][0])
        i = int(np.where(self.lats - lat >= 0)[0][0])
        if self.lons[j] == lon and self.lats[i] == lat:
            return i, j
        Dx = self.lons[j] - self.lons[j - 1]
        Dy = self.lats[i] - self.lats[i - 1]
        dx = lon - self.lons[j - 1]
        dy = lat - self.lats[i - 1]
        return i, j, dx, dy, Dx, Dy

    def copy(self):
        from copy import deepcopy
        return deepcopy(self)


class GeoMap(GeoGrid):
    def __init__(self, lons=(), lats=(), z=None, mask=None):
        super().__init__(lons, lats)
        self.z = np.asarray(z, dtype=float) if z is not None else None
        self.mask = (np.asarray(mask, dtype=bool) if mask is not None
                     else (np.isnan(self.z) if self.z is not None else None))

    @property
    def zMasked(self):
        return np.ma.masked_array(self.z, mask=self.mask
                                  | np.isnan(self.z))

    def value(self, lon, lat):
        ind = self._findInd_linear_interp(lon, lat)
        if ind is None:
            return np.nan
        if len(ind) == 2:
            return self.z[ind]
        i, j, dx, dy, Dx, Dy = ind
        p0, p1 = self.z[i - 1, j - 1], self.z[i, j - 1]
        p2, p3 = self.z[i - 1, j], self.z[i, j]
        return (p0 + (p1 - p0) * dy / Dy + (p2 - p0) * dx / Dx
                + (p0 + p3 - p1 - p2) * dx * dy / Dx / Dy)

    def smooth(self, tension=0.0, width=50.0, device="cuda"):
        """NaN-aware smoothing with half-width ``width`` km.

        ``tension=0`` (the reference's default) uses the separable
        Gaussian; ``tension>0`` uses the spline-in-tension spectral
        filter (:func:`tension_spline_smooth`), the GMT ``surface``
        analogue — both share the same half-power wavelength, and their
        tension->0 deviation is quantified in
        ``tests/test_geo.py::test_tension_smoothing_parity``.
        """
        if tension > 0:
            zNew = tension_spline_smooth(self.lons, self.lats,
                                         self.z[None], width, tension,
                                         device=device)[0]
        else:
            zNew = gaussian_smooth_nan(self.lons, self.lats, self.z[None],
                                       width, device=device)[0]
        return GeoMap(self.lons, self.lats, zNew)

    def _lon_range_change_to(self, rng):
        if rng == "-180 to 180":
            self.lons = self.lons - 360 * (self.lons > 180)
        else:
            self.lons = self.lons + 360 * (self.lons < 0)


def _gauss_kernel(dx_km, width_km, nsig=3.0):
    sigma = max(width_km / 2.0, 1e-6)  # width = full width at ~1 sigma
    n = max(int(np.ceil(nsig * sigma / dx_km)), 1)
    x = np.arange(-n, n + 1) * dx_km
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _spacing_km(lons, lats):
    """(dlat, dlon) grid spacing in km; the lon metric at the mean
    latitude (adequate for regional grids)."""
    dlat_km = abs(lats[1] - lats[0]) * DEG2KM
    dlon_km = (abs(lons[1] - lons[0]) * DEG2KM
               * np.cos(np.deg2rad(np.mean(lats))))
    return dlat_km, dlon_km


def _conv_edge(x, k, dim):
    """Cross-correlate ``x`` (B, ny, nx) with the odd 1-D kernel ``k``
    along ``dim`` (1 or 2), edge-padded: one ``conv1d`` over every row."""
    import torch
    import torch.nn.functional as F

    x = x.movedim(dim, -1)
    shape = x.shape
    pad = (k.shape[0] - 1) // 2
    rows = F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="replicate")
    out = F.conv1d(rows, k.reshape(1, 1, -1)).reshape(shape)
    return out.movedim(-1, dim)


def _gaussian_smooth_core(lons, lats, z, width_km):
    """Normalized-convolution Gaussian smooth of the tensor ``z`` (B, ny,
    nx); values everywhere (no NaN restore) — NaN cells get their
    Gaussian-weighted neighborhood mean, which is also how the tension
    filter infills."""
    import torch

    dlat_km, dlon_km = _spacing_km(lons, lats)
    kw = dict(dtype=z.dtype, device=z.device)
    k_lat = torch.as_tensor(_gauss_kernel(dlat_km, width_km), **kw)
    k_lon = torch.as_tensor(_gauss_kernel(dlon_km, width_km), **kw)
    good = torch.isfinite(z)
    z0 = torch.where(good, z, 0.0)
    w0 = good.to(z.dtype)
    num = _conv_edge(_conv_edge(z0 * w0, k_lat, 1), k_lon, 2)
    den = _conv_edge(_conv_edge(w0, k_lat, 1), k_lon, 2)
    return num / torch.clamp(den, min=1e-12)


def _fields(fields, device):
    import torch

    return torch.as_tensor(np.asarray(fields, dtype=float),
                           dtype=torch.float64, device=device)


def gaussian_smooth_nan(lons, lats, fields, width_km, device="cuda"):
    """Batched NaN-aware separable Gaussian smoothing on the device.

    Args:
      lons, lats: 1-D grid coordinates (degrees).
      fields: (B, nlat, nlon) stack of maps (NaN = missing).
      width_km: smoothing width in km (like GeoMap.smooth(width=...)).
      device: where the convolutions run (float64).

    Returns (B, nlat, nlon) numpy with NaNs restored where inputs were
    NaN.  Normalized convolution handles missing data; the lon kernel
    uses the metric at the mean latitude (adequate for regional grids).
    """
    import torch

    z = _fields(fields, device)
    sm = _gaussian_smooth_core(lons, lats, z, width_km)
    return torch.where(torch.isfinite(z), sm, np.nan).cpu().numpy()


def gaussian_smooth_nan_fill(lons, lats, fields, width_km, device="cuda"):
    """Gaussian-weighted infill values (normalized conv without the
    final NaN restore) — used to seed the spectral tension filter."""
    import torch

    z = _fields(fields, device)
    sm = _gaussian_smooth_core(lons, lats, z, width_km)
    return torch.where(torch.isfinite(z), z, sm).cpu().numpy()


def _dct_ortho(x, dim):
    """Orthonormal DCT-II along ``dim`` (scipy's ``dct(type=2,
    norm="ortho")``) from one FFT of the even/odd reordering
    (Makhoul 1980): ``y_k = 2 Re(exp(-i pi k / 2N) FFT(v)_k)`` scaled
    by sqrt(1/4N) at k = 0 and sqrt(1/2N) elsewhere."""
    import torch

    x = x.movedim(dim, -1)
    N = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(N, dtype=x.dtype, device=x.device)
    tw = torch.polar(torch.ones_like(k), -np.pi * k / (2 * N))
    y = 2.0 * (torch.fft.fft(v, dim=-1) * tw).real
    scale = torch.full_like(k, np.sqrt(1.0 / (2 * N)))
    scale[0] = np.sqrt(1.0 / (4 * N))
    return (y * scale).movedim(-1, dim)


def _idct_ortho(y, dim):
    """Inverse of :func:`_dct_ortho` (the orthonormal DCT-III): with
    ``c_k = y_k sqrt(1/N)`` at k = 0 and ``y_k sqrt(2/N)`` elsewhere,
    ``v = Re(N IFFT(c_k exp(i pi k / 2N)))`` holds the even samples
    ``x_2m = v_m`` and the odd ones reversed, ``x_2m+1 = v_N-1-m``."""
    import torch

    y = y.movedim(dim, -1)
    N = y.shape[-1]
    k = torch.arange(N, dtype=y.dtype, device=y.device)
    scale = torch.full_like(k, np.sqrt(2.0 / N))
    scale[0] = np.sqrt(1.0 / N)
    tw = torch.polar(torch.ones_like(k), np.pi * k / (2 * N))
    v = (N * torch.fft.ifft(y * scale * tw, dim=-1)).real
    x = torch.empty_like(v)
    n_even = (N + 1) // 2
    x[..., ::2] = v[..., :n_even]
    x[..., 1::2] = v[..., n_even:].flip(-1)
    return x.movedim(-1, dim)


def tension_spline_smooth(lons, lats, fields, width_km, tension=0.25,
                          device="cuda"):
    """Spline-in-tension low-pass smoothing — the GMT ``surface`` family.

    GMT's ``surface`` grids data by solving the spline-in-tension PDE
    ``(1-T) L(L z) - T L z = 0`` (Smith & Wessel, Geophysics 1990,
    ``-T`` flag).  The smoothing analogue on an already-complete grid is
    Tikhonov regularisation with the same operator,

        min  ||z - z0||^2 + lam [ (1-T) ||Lap z||^2 + T ||grad z||^2 ]

    whose normal equations diagonalise in the DCT-II basis (Neumann
    boundaries, matching ``surface``'s natural-spline edges):

        H(k) = 1 / (1 + lam ((1-T) |k|^4 + T |k|^2)).

    ``lam`` is chosen so the half-power wavenumber equals the Gaussian
    smoother's (sigma = width/2 -> k_c = sqrt(2 ln 2) / sigma), so the
    two smoothers are directly comparable at any tension.  T -> 1
    weakens the k^4 (biharmonic) term toward a harmonic membrane,
    which is exactly GMT's "suppress spline overshoot" control.

    NaNs are infilled by normalized Gaussian convolution before the
    spectral filter and restored afterwards.  Everything runs on
    ``device``: the orthonormal DCT-II / DCT-III are built on
    ``torch.fft`` (:func:`_dct_ortho`, :func:`_idct_ortho`).

    Args/returns as :func:`gaussian_smooth_nan`, plus ``tension`` in
    [0, 1).
    """
    import torch

    z = _fields(fields, device)
    good = torch.isfinite(z)
    # infill missing values so the spectral filter sees a complete grid
    filled = torch.where(good, z, _gaussian_smooth_core(lons, lats, z,
                                                        width_km))
    filled = torch.where(torch.isfinite(filled), filled,
                         torch.nanmean(z, dim=(1, 2), keepdim=True))

    dlat_km, dlon_km = _spacing_km(lons, lats)
    B, ny, nx = filled.shape
    ky = np.pi * np.arange(ny) / (ny * dlat_km)
    kx = np.pi * np.arange(nx) / (nx * dlon_km)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    sigma = max(width_km / 2.0, 1e-6)
    kc2 = 2.0 * np.log(2.0) / sigma**2          # Gaussian half-power
    T = float(np.clip(tension, 0.0, 0.999))
    lam = 1.0 / ((1.0 - T) * kc2**2 + T * kc2)
    Hf = torch.as_tensor(1.0 / (1.0 + lam * ((1.0 - T) * k2**2 + T * k2)),
                         dtype=z.dtype, device=z.device)

    coef = _dct_ortho(_dct_ortho(filled, 1), 2)
    sm = _idct_ortho(_idct_ortho(coef * Hf[None], 1), 2)
    return torch.where(good, sm, np.nan).cpu().numpy()


def mapSmooth(lons, lats, z, tension=0.0, width=50.0, device="cuda"):
    """Drop-in for the reference's mapSmooth (model3D.py:11-14).

    ``tension=0`` (the reference's call signature default) routes to
    the Gaussian smoother; ``tension>0`` to the spline-in-tension
    spectral filter.
    """
    if tension > 0:
        zNew = tension_spline_smooth(lons, lats, np.asarray(z)[None],
                                     width, tension, device=device)[0]
    else:
        zNew = gaussian_smooth_nan(lons, lats, np.asarray(z)[None],
                                   width, device=device)[0]
    zNew[np.isnan(z)] = np.nan
    return zNew


# ---------------------------------------------------------------------------
# Great-circle sampling (geographiclib replacement, spherical earth)
# ---------------------------------------------------------------------------

def gc_inverse(lat1, lon1, lat2, lon2):
    """Distance (m) and initial azimuth (deg) along the great circle."""
    p1, p2 = np.deg2rad(lat1), np.deg2rad(lat2)
    dl = np.deg2rad(lon2 - lon1)
    d = np.arccos(np.clip(np.sin(p1) * np.sin(p2)
                          + np.cos(p1) * np.cos(p2) * np.cos(dl), -1, 1))
    az = np.arctan2(np.sin(dl) * np.cos(p2),
                    np.cos(p1) * np.sin(p2)
                    - np.sin(p1) * np.cos(p2) * np.cos(dl))
    return {"s12": d * EARTH_R_KM * 1000.0, "azi1": np.rad2deg(az)}


def gc_direct(lat1, lon1, azi1, s12_m):
    """Point at distance s12 (m) along azimuth azi1 from (lat1, lon1)."""
    p1 = np.deg2rad(lat1)
    az = np.deg2rad(azi1)
    d = s12_m / 1000.0 / EARTH_R_KM
    p2 = np.arcsin(np.sin(p1) * np.cos(d)
                   + np.cos(p1) * np.sin(d) * np.cos(az))
    l2 = np.deg2rad(lon1) + np.arctan2(
        np.sin(az) * np.sin(d) * np.cos(p1),
        np.cos(d) - np.sin(p1) * np.sin(p2))
    return {"lat2": np.rad2deg(p2), "lon2": np.rad2deg(l2)}

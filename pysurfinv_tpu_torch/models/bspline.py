"""Cubic B-spline basis on an exponentially stretched knot vector.

Capability spec from the reference pySurfInv (``layers.py:4-45``):
  * nBasis == 1: a single constant basis function;
  * nBasis == 2: two linear ramp functions (1->0 and 0->1);
  * otherwise: open-knot Cox-de Boor construction of order ``deg``
    (``deg = 3 if nBasis < 4 else 4``) on knots whose interior spacing
    grows geometrically with ``alpha = 2`` — finer control near the top
    of the layer, which is where surface waves resolve structure.

The basis only depends on (number of grid points, nBasis, deg) because
layer grids are uniform linspaces: the knot vector scales affinely with
the z-range.  We therefore precompute the (nBasis, n) matrix once on the
host (cached) and the evaluation is a single small matmul
``coef @ basis``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

EPS = np.finfo(float).eps


@lru_cache(maxsize=256)
def bspline_basis(n: int, n_basis: int, deg: int | None = None,
                  alpha: float = 2.0) -> np.ndarray:
    """Return the (n_basis, n) basis matrix on a normalized [0, 1] grid."""
    if n_basis == 1:
        return np.ones((1, n))
    if n_basis == 2:
        out = np.empty((2, n))
        out[0] = np.linspace(1.0, 0.0, n)
        out[1] = np.linspace(0.0, 1.0, n)
        return out
    if deg is None:
        deg = 3 + (n_basis >= 4)

    m = n_basis
    # Open knot vector with geometric interior spacing (layers.py:18-24).
    x = np.zeros(m + deg)
    x[: deg - 1] = -EPS
    x[deg - 1] = 0.0
    x[deg:m] = np.power(alpha, np.arange(m - deg)) * (alpha - 1) / (
        np.power(alpha, m - deg + 1) - 1)
    x[m] = 1.0
    x[m + 1:] = 1.0 + EPS

    z = np.linspace(0.0, 1.0, n)
    # Cox-de Boor: order-1 indicator functions, then deg-1 elevations.
    nb = len(x) - 1
    b = np.zeros((n, nb))
    for i in range(nb):
        b[(z >= x[i]) & (z < x[i + 1]), i] = 1.0
    for k in range(1, deg):
        nxt = np.zeros_like(b)
        for i in range(nb - k):
            left = x[i + k] - x[i]
            right = x[i + k + 1] - x[i + 1]
            if left != 0.0:
                nxt[:, i] += b[:, i] * (z - x[i]) / left
            if right != 0.0:
                nxt[:, i] += b[:, i + 1] * (x[i + k + 1] - z) / right
        b = nxt
    return np.ascontiguousarray(b[:, :m].T)


class BsplBasis:
    """Reference-compatible wrapper: ``BsplBasis(z, n) * coef`` -> values."""

    def __init__(self, z, n, deg=None, alpha=2.0, eps=EPS):
        self.n = len(z)
        self.nBasis = n
        self.deg = deg if deg is not None else 3 + (n >= 4)
        self.alpha = alpha
        self.basis = bspline_basis(self.n, n, None if deg is None else deg,
                                   alpha)

    def __mul__(self, coef):
        coef = np.atleast_1d(np.asarray(coef, dtype=float))
        return coef @ self.basis

"""Biswas (1972) spherical-to-flat earth transform, vectorised in PyTorch.

Behavioural spec from the reference implementation
(pySurfInv's ``fast_surf_src/flat1.f:2-73``):

  * radii of layer tops:  r_i = R0 - sum_{j<i} h_j  (surface r_0 = R0)
  * finite layer i (0-based, i < n-1), with f_i = ln(r_i / r_{i+1}):
      - velocity factor   dif_i = (1/r_{i+1} - 1/r_i) * R0 / f_i
      - density factor    qqq_i = (r_i^pwr - r_{i+1}^pwr) / (f_i * R0^pwr * pwr)
      - flat thickness    h'_i  = R0 * f_i
  * halfspace (i = n-1): fact = R0 / r_{n-1};  vp,vs *= fact;
      rho *= (r_{n-1}/R0)^pwr;  h' = 0
  * pwr = 2.275 for Rayleigh, 5.0 for Love.

The transform is geometric only: it commutes with the per-period
attenuation rescale of velocities, so the factors are computed once per
model and reused for every period.

Padded-layout convention used throughout the package: arrays have a
length ``L`` on their last axis; real finite layers occupy indices
``0..nlay-2``, the halfspace sits at ``nlay-1``, indices ``>= nlay``
replicate the halfspace with ``h = 0``.  Zero-thickness layers are exact
identities in both secular recursions, so padding does not change the
physics.  Every function here takes a batch of models as leading axes,
with ``nlay`` an int or an integer tensor of the batch shape.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

R0 = 6371.0  # Earth radius in km (flat1.f:21)
H_MIN = 1e-3  # thin-layer threshold, models.py:20 of the reference


class FlatFactors(NamedTuple):
    """Period-independent earth-flattening factors for padded models."""

    h_flat: torch.Tensor    # flattened thicknesses (..., L); 0 from halfspace
    vel_fac: torch.Tensor   # multiplicative factor for vp and vs (..., L)
    rho_fac: torch.Tensor   # multiplicative factor for rho (..., L)


def _layer_index(h, nlay):
    """(layer index (L,), nlay broadcast against (..., L))."""
    idx = torch.arange(h.shape[-1], device=h.device)
    nl = torch.as_tensor(nlay, device=h.device)[..., None]
    return idx, nl


def flatten_factors(h: torch.Tensor, nlay, kind: int) -> FlatFactors:
    """Earth-flattening factors for padded layer stacks.

    Args:
      h:    (..., L) layer thicknesses in km; index nlay-1 is the halfspace
            (its ``h`` is ignored and treated as 0), pads have h = 0.
      nlay: number of real layers incl. halfspace (int or (...) tensor).
      kind: 1 for Love (pwr = 5.0), 2 for Rayleigh (pwr = 2.275).

    Returns FlatFactors whose entries at and after the halfspace index
    carry the halfspace scaling, so truncated-halfspace gathers read
    consistent values.
    """
    idx, nl = _layer_index(h, nlay)
    is_finite_layer = idx < (nl - 1)
    zero = torch.zeros_like(h)
    h_eff = torch.where(is_finite_layer, h, zero)

    pwr = 5.0 if kind == 1 else 2.275

    # Radii of layer tops; pads and halfspace all share r_top(halfspace).
    z_top = torch.cumsum(h_eff, dim=-1) - h_eff
    r_top = R0 - z_top
    r_bot = R0 - (z_top + h_eff)

    # Finite-layer factors; guard h == 0 (f -> 0) with identity factors.
    thin = h_eff <= 0.0
    r_top_s = torch.where(thin, torch.full_like(h, R0), r_top)
    r_bot_s = torch.where(thin, torch.full_like(h, R0 / math.e), r_bot)
    f = torch.log(r_top_s / r_bot_s)
    dif = (1.0 / r_bot_s - 1.0 / r_top_s) * R0 / f
    qqq = (r_top_s**pwr - r_bot_s**pwr) / (f * R0**pwr * pwr)
    h_flat_fin = R0 * f

    # Halfspace factors (flat1.f:58-62), shared by pads.
    fact_h = R0 / r_top
    rho_h = (r_top / R0) ** pwr

    one = torch.ones_like(h)
    fin = is_finite_layer & ~thin
    vel_fac = torch.where(fin, dif, torch.where(is_finite_layer, one, fact_h))
    rho_fac = torch.where(fin, qqq, torch.where(is_finite_layer, one, rho_h))
    h_flat = torch.where(fin, h_flat_fin, zero)
    return FlatFactors(h_flat=h_flat, vel_fac=vel_fac, rho_fac=rho_fac)


def effective_thickness(h: torch.Tensor, nlay) -> torch.Tensor:
    """Thin layers and the halfspace/pads zeroed out — the ``h > 1e-3``
    filter applied before calling fast_surf (models.py:20), as exact
    identity rows instead of compaction."""
    idx, nl = _layer_index(h, nlay)
    thin = (idx < nl - 1) & (h <= H_MIN)
    return torch.where(thin | (idx >= nl - 1), torch.zeros_like(h), h)


def model_preamble(h: torch.Tensor, nlay, kind: int, flat: bool):
    """(h_eff, FlatFactors): thin-layer zeroing plus flattening factors
    (or identity factors when ``flat`` is False)."""
    h_eff = effective_thickness(h, nlay)
    if flat:
        return h_eff, flatten_factors(h_eff, nlay, kind)
    ones = torch.ones_like(h_eff)
    return h_eff, FlatFactors(h_flat=h_eff, vel_fac=ones, rho_fac=ones)

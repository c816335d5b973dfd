"""Secular functions as parallel trees of propagator-matrix products.

Counterpart of the JAX package's ``ops/secular_assoc.py``.  The depth
recursion of the Thomson–Haskell / Dunkin secular functions
(``surfa.f:87``) is an associative chain of per-layer matrix products —
5x5 for the Rayleigh reduced-delta update (``surfa.f:326-335``), 2x2 for
the Love Haskell update (``surfa.f:135-183``) — so it can be evaluated as
a log-depth binary product tree instead of a sequential loop:

    F(c, T) = closure . ( M_{L-2} @ ... @ M_1 @ M_0 ) . e_seed

Each tree level combines adjacent pairs ``M'[m] = M[2m+1] @ M[2m]`` with a
per-matrix max-abs renormalisation (sign-preserving, detached — the AD
convention of :mod:`pysurfinv_tpu_torch.ops.secular`), so the result
equals the sequential recursion up to a positive per-evaluation scale;
roots, sign structure and tangent *ratios* are identical.  The order of
association and the renormalisation points are the JAX module's, so the
two trees agree to rounding.

The tree does 5x the flops of the sequential Rayleigh recursion (full
matrix-matrix products against matrix-vector ones) and is not a default:
it is the eager cross-check behind ``SurfConfig(backend="xla_assoc")``.
Every function broadcasts over leading batch axes as the sequential ones
do: ``c``/``t``/``mmax`` of the batch shape, model arrays ``(..., L)``.
"""

from __future__ import annotations

import torch

from pysurfinv_tpu_torch.ops.secular import (ACCUR, TWO_PI, _at,
                                             _dunkin_closure, _dunkin_matrix)


def _renorm(M):
    """Sign-preserving max-abs rescale per matrix; AD constant."""
    scale = M.abs().amax(dim=(-2, -1), keepdim=True).detach()
    return M / torch.where(scale > 0.0, scale, torch.ones_like(scale))


def _tree_product(M):
    """``M[..., n-1, :, :] @ ... @ M[..., 0, :, :]`` by a log-depth
    pairwise tree over the layer axis (-3), n a power of two (pad with
    identities); every combined product is renormalised."""
    while M.shape[-3] > 1:
        A, Bm = M[..., 1::2, :, :], M[..., 0::2, :, :]
        # A @ B as a broadcast multiply and sum, the JAX module's form
        M = _renorm((A[..., :, :, None] * Bm[..., None, :, :]).sum(dim=-2))
    return M[..., 0, :, :]


def _pad_pow2(M):
    n = M.shape[-3]
    p = 1
    while p < n:
        p *= 2
    if p == n:
        return M
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(
        M.shape[:-3] + (p - n,) + M.shape[-2:])
    return torch.cat([M, eye], dim=-3)


def rayleigh_secular_assoc(c, t, a, b, rho, d, mmax):
    """Tree-product evaluation of the Dunkin Rayleigh secular function.

    Same arguments and root structure as
    :func:`pysurfinv_tpu_torch.ops.secular.rayleigh_secular`; the value
    differs by a positive per-evaluation scale only.
    """
    c = torch.as_tensor(c, dtype=a.dtype)
    t = torch.as_tensor(t, dtype=a.dtype)
    mmax = torch.as_tensor(mmax, device=a.device)
    wvno = TWO_PI / (c * t)
    csq = c * c
    L = a.shape[-1]
    apply = (torch.arange(L - 1, device=a.device)
             < (mmax[..., None] - 1))[..., None, None]
    M, _ = _dunkin_matrix(c, csq, wvno, a[..., :-1], b[..., :-1],
                          rho[..., :-1], d[..., :-1])     # (..., L-1, 5, 5)
    eye = torch.eye(5, dtype=a.dtype, device=a.device)
    M = _renorm(torch.where(apply, M, eye))
    T = _tree_product(_pad_pow2(M))

    h = mmax - 1
    return -_dunkin_closure(c, csq, _at(a, h), _at(b, h), _at(rho, h),
                            T[..., :, 0])


def love_secular_assoc(c, t, b, rho, d, mmax):
    """Tree-product evaluation of the Haskell Love secular function.

    Propagation runs from the effective halfspace up to the surface
    (``surfa.f:135-183``): with the layer matrices H_l the surface state
    is ``H_0 @ H_1 @ ... @ H_{m-2} @ s_half``, one reversed product tree.
    Water layers (vs = 0) are identity (skipped, surfa.f:150-152).
    """
    c = torch.as_tensor(c, dtype=b.dtype)
    t = torch.as_tensor(t, dtype=b.dtype)
    mmax = torch.as_tensor(mmax, device=b.device)
    wvno = TWO_PI / (c * t)
    L = b.shape[-1]

    h = mmax - 1
    bh = _at(b, h)
    b_h = torch.where(bh.abs() > ACCUR, bh, torch.ones_like(bh))
    rb_h = torch.sqrt(((c / b_h) ** 2 - 1.0).abs())
    s0 = torch.stack([torch.ones_like(b_h), _at(rho, h) * b_h * b_h * rb_h],
                     dim=-1)
    scale0 = s0.abs().amax(dim=-1, keepdim=True).detach()
    s0 = s0 / torch.where(scale0 > 0, scale0, torch.ones_like(scale0))

    b_m, rho_m, d_m = b[..., :-1], rho[..., :-1], d[..., :-1]
    c_, wv = c[..., None], wvno[..., None]
    water = b_m.abs() <= ACCUR
    apply = (torch.arange(L - 1, device=b.device)
             <= (mmax[..., None] - 2)) & ~water
    b_safe = torch.where(water, torch.ones_like(b_m), b_m)
    rb = torch.sqrt(((c_ / b_safe) ** 2 - 1.0).abs())
    hmu = rho_m * b_safe * b_safe
    q = -wv * d_m * rb
    osc = (c_ > b_safe) & (rb >= 1e-20)
    ev = (c_ < b_safe) & (rb >= 1e-20)
    zero, one = torch.zeros_like(q), torch.ones_like(q)
    q_osc = torch.where(osc, q, zero)
    q_ev = torch.where(ev, q, zero)
    rb_safe = torch.where(rb >= 1e-20, rb, one)
    eq = torch.exp(q_ev)
    shq, chq = 0.5 * (eq - 1.0 / eq), 0.5 * (eq + 1.0 / eq)
    y = torch.where(osc, torch.sin(q_osc) / rb_safe,
                    torch.where(ev, shq / rb_safe, -wv * d_m * one))
    z = torch.where(osc, rb * torch.sin(q_osc),
                    torch.where(ev, -rb * shq, zero))
    cosq = torch.where(osc, torch.cos(q_osc), torch.where(ev, chq, one))

    H = torch.stack([torch.stack([cosq, -y / hmu], dim=-1),
                     torch.stack([hmu * z, cosq], dim=-1)], dim=-2)
    eye = torch.eye(2, dtype=b.dtype, device=b.device)
    H = torch.where(apply[..., None, None], H, eye)
    # surface state = H_0 @ H_1 @ ... @ H_{L-2} @ s0: reverse the layer
    # axis so the tree's "apply left-to-right" order matches
    T = _tree_product(_pad_pow2(_renorm(H.flip(-3))))
    s = (T @ s0[..., None])[..., 0]
    return -s[..., 1]

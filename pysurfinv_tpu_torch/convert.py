"""Carry inputs across from the JAX package's layout.

The JAX package's batched solver takes ``(B, L)`` arrays ``h, vp, vs,
rho, qsinv`` (``qsinv = 1/Qs``) and ``(B,)`` layer counts — exactly what
``bench.py`` and the tests build with numpy — and its samplers take a
``BrownianSpec``, per-lane constants ``psi`` and per-lane PRNG keys.
This module turns such numpy arrays into the port's tensors, so the same
model and the same sampler state can be handed to both packages.  Like
every entry point of the port, each function puts its tensors on the
card unless the caller asks for another device.
"""

from __future__ import annotations

import numpy as np
import torch


def model_batch_from_numpy(h, vp, vs, rho, qsinv, nlay, *, device="cuda",
                           dtype=torch.float32):
    """(B, L) numpy model arrays -> the port's tensors.

    Returns ``(h, vp, vs, rho, qsinv, nlay)``: five contiguous ``(B, L)``
    tensors of ``dtype`` and an int32 ``(B,)`` ``nlay`` (a scalar
    ``nlay`` is broadcast to the batch), all on ``device``.
    """
    arrs = [np.asarray(x) for x in (h, vp, vs, rho, qsinv)]
    shape = arrs[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in arrs):
        raise ValueError("h, vp, vs, rho, qsinv must share one (B, L) shape, "
                         f"got {[a.shape for a in arrs]}")
    nl = np.broadcast_to(np.asarray(nlay), (shape[0],))
    if nl.min() < 2 or nl.max() > shape[1]:
        raise ValueError(f"nlay must lie in [2, L={shape[1]}], got "
                         f"[{nl.min()}, {nl.max()}]")
    out = [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device) for a in arrs]
    out.append(torch.as_tensor(nl.astype(np.int32), device=device))
    return tuple(out)


def spec_from_numpy(spec, psi=None, *, device="cuda", dtype=torch.float64):
    """A ``BrownianSpec`` (and ``psi``) of numpy arrays -> the port's.

    ``spec`` is any 4-field ``(theta0, vmin, vmax, step)`` record — the
    JAX package's ``BrownianSpec`` converted with ``np.asarray``, or the
    port's own from ``CompiledModel.spec_of`` — with matching shapes
    (``(ntheta,)`` or lane-stacked ``(N, ntheta)``).  Returns the port's
    :class:`~pysurfinv_tpu_torch.inversion.compiled.BrownianSpec` of
    ``dtype`` tensors on ``device``, and ``psi`` likewise when given.
    """
    from pysurfinv_tpu_torch.inversion.compiled import BrownianSpec

    fields = [np.asarray(x, np.float64) for x in spec]
    if len(fields) != 4 or any(f.shape != fields[0].shape for f in fields):
        raise ValueError("spec must hold theta0, vmin, vmax, step of one "
                         f"shape, got {[f.shape for f in fields]}")
    out = BrownianSpec(*(torch.as_tensor(f, dtype=dtype, device=device)
                         for f in fields))
    if psi is None:
        return out
    return out, torch.as_tensor(np.asarray(psi, np.float64), dtype=dtype,
                                device=device)


def lane_keys_from_numpy(keys, *, device="cuda"):
    """``(..., 2)`` uint32 threefry keys (``jax.random.key_data`` or a
    legacy ``PRNGKey`` array, as numpy) -> the port's int64 key tensor
    (:mod:`pysurfinv_tpu_torch.inversion.random`)."""
    k = np.asarray(keys)
    if k.shape[-1:] != (2,) or k.dtype.kind not in "ui":
        raise ValueError(f"keys must be (..., 2) integers, got {k.dtype} "
                         f"{k.shape}")
    if k.min() < 0 or k.max() > 0xFFFFFFFF:
        raise ValueError("keys must hold 32-bit unsigned words")
    return torch.as_tensor(k.astype(np.int64), device=device)

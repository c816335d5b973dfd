"""Carry model batches across from the JAX package's layout.

The JAX package's batched solver takes ``(B, L)`` arrays ``h, vp, vs,
rho, qsinv`` (``qsinv = 1/Qs``) and ``(B,)`` layer counts — exactly what
``bench.py`` and the tests build with numpy.  This module turns such
numpy arrays into the port's tensors, so the same model can be handed to
both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def model_batch_from_numpy(h, vp, vs, rho, qsinv, nlay, *, device="cpu",
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

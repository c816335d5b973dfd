"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Each test hands the same numpy arrays, made from a seed, to the JAX
package and to the port and compares the outputs.
"""

import os

import numpy as np

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "test1.npz")


def load_eus_model():
    """The eus_model fixture of tests/conftest.py:65-84 without the
    conftest (which imports JAX): for tests that also run where JAX is
    absent, on the GPU machine."""
    g = np.load(GOLDEN)
    h, vp, vs = g["model_h"], g["model_vp"], g["model_vs"]
    rho, qs = g["model_rho"], g["model_qs"]
    nlay, L = len(h), 72

    def pad(x, fill):
        return np.concatenate([x, np.full(L - nlay, fill)])

    return {"h": pad(h, 0.0), "vp": pad(vp, vp[-1]), "vs": pad(vs, vs[-1]),
            "rho": pad(rho, rho[-1]), "qsinv": pad(1.0 / qs, 1.0 / qs[-1]),
            "nlay": nlay, "periods": g["periods"].astype(float)}


def eus_batch(eus_model, B=3, dtype=np.float32, seed=7):
    """B copies of the eus model, models 1.. with a 1% Vs/Vp jitter —
    the batch of tests/test_pallas_secular.py:30-43."""
    m = eus_model
    rng = np.random.default_rng(seed)
    mk = lambda x: np.repeat(np.asarray(x, dtype)[None], B, 0)  # noqa: E731
    h, vp, vs = mk(m["h"]), mk(m["vp"]), mk(m["vs"])
    rho, qsi = mk(m["rho"]), mk(m["qsinv"])
    pert = (1.0 + 0.01 * rng.standard_normal(vs.shape)).astype(dtype)
    vs[1:] *= pert[1:]
    vp[1:] *= pert[1:]
    nlay = np.full((B,), m["nlay"], np.int32)
    return h, vp, vs, rho, qsi, nlay


def with_water_top(batch, H=2.0):
    """Append one model with a water layer (vs = 0) on top of model 0:
    the liquid regime of the Rayleigh recursion."""
    h, vp, vs, rho, qsi, nlay = (np.asarray(x) for x in batch)
    n = int(nlay[0])
    if n + 1 > h.shape[1]:
        raise ValueError("no room for a water layer in the padding")
    shift = lambda x, top: np.concatenate([[top], x[0, :-1]])  # noqa: E731
    row = [shift(h, H), shift(vp, 1.475), shift(vs, 0.0), shift(rho, 1.027),
           shift(qsi, 1e-4)]
    out = [np.concatenate([a, r[None].astype(a.dtype)])
           for a, r in zip((h, vp, vs, rho, qsi), row)]
    out.append(np.concatenate([nlay, [n + 1]]).astype(np.int32))
    return tuple(out)


def root_brackets(c, t, model, nlay, wave, c0=0.5, n=460):
    """dc-wide brackets [lo, lo + 0.01] around each (period, model) lane's
    lowest root, with the closure frozen at the upper end (the solver's
    convention): the first sign change of F on a 0.01 km/s scan from
    ``c0``.  ``c`` only gives the (K, B) lane shape; float32 torch
    tensors in, (lo, hi, mm_frozen) out."""
    import torch

    from pysurfinv_tpu_torch.ops.secular_lanes import secular_lanes_plain

    K, B = c.shape
    cs = c0 + 0.01 * torch.arange(n, dtype=torch.float32)
    grid = cs[:, None, None].expand(n, K, B).reshape(n * K, B).contiguous()
    F, _, _ = secular_lanes_plain(
        grid, t.repeat(n, 1), torch.zeros(grid.shape, dtype=torch.int32),
        *model, nlay, wave=wave)
    s = torch.sign(F).reshape(n, K, B)
    flip = torch.argmax((s[:-1] != s[1:]).to(torch.int8), dim=0)
    lo = cs[flip].contiguous()
    hi = lo + 0.01
    _, _, mm = secular_lanes_plain(hi, t, torch.zeros(c.shape,
                                   dtype=torch.int32), *model, nlay,
                                   wave=wave)
    return lo, hi, mm


def _standin_c(xp, h, vs, per):
    """c (B, P) of the stand-in solve; ``xp`` is torch or jax.numpy."""
    if per.ndim == 1:
        per = per[None]
    z = xp.cumsum(h, -1) - 0.5 * h
    w = xp.exp(-z[:, None, :] / (1.2 * per[:, :, None])) * h[:, None, :]
    return 0.9 * xp.sum(w * vs[:, None, :], -1) / xp.sum(w, -1)


def standin_solve_torch(h, vp, vs, rho, qsinv, periods, nlay,
                        wave="rayleigh", cfg=None, c_warm=None,
                        round32=True):
    """A closed-form stand-in for the port's ``surf_forward_batch``: a
    smooth function of the built profile (a depth-weighted mean Vs per
    period, the weight exp(-z / 1.2 T)), returning ``(c, u, ok)`` of the
    solve's (B, P, 1) shapes, float64.  ``round32`` rounds the profile to
    float32 first: the port's sampler hands the solve float32 profiles,
    the JAX package's float64 ones, and both then feed the formula the
    same numbers."""
    import torch

    h, vs, periods = (torch.as_tensor(x) for x in (h, vs, periods))
    if round32:
        h, vs, periods = (x.to(torch.float32) for x in (h, vs, periods))
    c = _standin_c(torch, *(x.to(torch.float64)
                            for x in (h, vs, periods)))[..., None]
    return c, c, torch.ones(c.shape, dtype=torch.bool, device=c.device)


def standin_solve_jax(h, vp, vs, rho, qsinv, periods, nlay,
                      wave="rayleigh", cfg=None, c_warm=None, round32=True):
    """:func:`standin_solve_torch` for the JAX package's
    ``surf_forward_batch``."""
    import jax.numpy as jnp

    h, vs, periods = (jnp.asarray(x) for x in (h, vs, periods))
    if round32:
        h, vs, periods = (x.astype(jnp.float32) for x in (h, vs, periods))
    c = _standin_c(jnp, *(x.astype(jnp.float64)
                          for x in (h, vs, periods)))[..., None]
    return c, c, jnp.ones(c.shape, bool)

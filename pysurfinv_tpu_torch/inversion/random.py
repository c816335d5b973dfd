"""Counter-based random streams: threefry2x32 keys in torch integer ops.

The JAX sampler keys every draw by (seed, global lane, global row)
(``parallel/grid.py:591-592``, ``inversion/mcmc.py:391-392, 413,
425-426``): a draw is a pure function of its key, so segmented runs equal
monolithic ones, tiled runs equal untiled ones, and the order in which
lanes are batched never matters.  A ``torch.Generator`` is a sequential
stream and gives none of that; this module reproduces the ``jax.random``
calls the sampler makes, bit for bit, with the layout JAX uses by default
(``jax_threefry_partitionable``: the i-th element of a draw hashes the
64-bit counter ``i``).

A key is an int64 tensor of shape ``(..., 2)`` holding two 32-bit words
(torch's uint32 arithmetic is thin, so every operation masks to 32 bits).
Keys are explicit arguments everywhere; there is no global state.

``fold_in``, ``split`` and ``random_bits`` (and the draws built on it)
dispatch on the device of the keys: CPU keys take the torch ops here,
the plain version (``_fold_in_plain``, ``_split_plain``,
``_random_bits_plain``); CUDA keys launch one Threefry kernel a call
(:mod:`pysurfinv_tpu_torch.ops.draw_lanes`), bitwise equal to the plain
version on the card.  Their ``backend="plain"`` forces the torch ops on
any device and ``backend="kernel"`` the kernel; they are for the tests.
"""

from __future__ import annotations

import math

import torch

from pysurfinv_tpu_torch.ops import draw_lanes as DL
from pysurfinv_tpu_torch.ops._cuda_build import _resolve

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under
    key ``(k1, k2)``; all int64 tensors of 32-bit words, broadcast
    together.  Matches ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed, device=None):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**63): the key
    ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 63:
        raise ValueError(f"seed must lie in [0, 2**63), got {seed}")
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(keys, data, backend="auto"):
    """``jax.random.fold_in`` of every key in ``keys`` (..., 2) with
    ``data`` (an int, or an integer tensor broadcast against the keys'
    leading shape): the hash of the counter (0, data)."""
    if _resolve("fold_in", backend, keys):
        return DL.fold_in(keys, data)
    return _fold_in_plain(keys, data)


def _fold_in_plain(keys, data):
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(keys, num=2, backend="auto"):
    """``jax.random.split(key, num)`` of every key: (..., num, 2).  Key
    ``i`` of the split is ``fold_in(key, i)``."""
    if _resolve("split", backend, keys):
        return DL.split(keys, num)
    return _split_plain(keys, num)


def _split_plain(keys, num=2):
    i = torch.arange(num, dtype=torch.int64, device=keys.device)
    return _fold_in_plain(keys[..., None, :], i)


def random_bits(keys, bit_width, shape, backend="auto"):
    """``jax.random.bits`` of width 32 or 64 for every key: a tensor of
    shape ``keys.shape[:-1] + shape``.  64-bit words come back as the
    pair ``(hi, lo)`` of 32-bit halves (int64 tensors cannot hold the
    top bit unsigned)."""
    if _resolve("random_bits", backend, keys):
        return DL.random_bits(keys, bit_width, shape)
    return _random_bits_plain(keys, bit_width, shape)


def _random_bits_plain(keys, bit_width, shape):
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=keys.device).reshape(shape)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(lead + (1,) * len(shape))
    k2 = keys[..., 1].reshape(lead + (1,) * len(shape))
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & _M32)
    b1, b2 = torch.broadcast_tensors(b1, b2)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return b1, b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit(keys, shape, dtype):
    """Uniform [0, 1) draws with JAX's mantissa construction."""
    if dtype == torch.float64:
        hi, lo = random_bits(keys, 64, shape)
        mant = (hi << 20) | (lo >> 12)         # top 52 bits
        return mant.to(torch.float64) * 2.0 ** -52
    if dtype == torch.float32:
        mant = random_bits(keys, 32, shape) >> 9   # top 23 bits
        return mant.to(torch.float32) * 2.0 ** -23
    raise TypeError(f"uniform draws are float32 or float64, got {dtype}")


def uniform(keys, shape=(), dtype=torch.float64, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for every
    key of ``keys`` (..., 2): shape ``keys.shape[:-1] + shape``;
    ``minval``/``maxval`` broadcast against it."""
    f = _unit(keys, tuple(shape), dtype)
    minval = torch.as_tensor(minval, dtype=dtype, device=keys.device)
    maxval = torch.as_tensor(maxval, dtype=dtype, device=keys.device)
    return torch.maximum(minval, f * (maxval - minval) + minval)


def normal(keys, shape=(), dtype=torch.float64):
    """``jax.random.normal(key, shape, dtype)`` for every key: the
    inverse-CDF draw ``sqrt(2) erfinv(u)`` with u uniform in
    ``[nextafter(-1, 0), 1)``."""
    one = torch.ones((), dtype=dtype, device=keys.device)
    u = uniform(keys, shape, dtype, minval=torch.nextafter(-one, 0 * one),
                maxval=one)
    return torch.tensor(math.sqrt(2.0), dtype=dtype,
                        device=keys.device) * torch.erfinv(u)


def truncated_normal(keys, lower, upper, shape, dtype=torch.float64):
    """``jax.random.truncated_normal(key, lower, upper, shape, dtype)``
    for every key: the inverse-CDF draw ``sqrt(2) erfinv(u)`` with u
    uniform in ``[erf(lower/sqrt2), erf(upper/sqrt2))``, clamped to the
    open interval (lower, upper)."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=keys.device)
    lower = torch.as_tensor(lower, dtype=dtype, device=keys.device)
    upper = torch.as_tensor(upper, dtype=dtype, device=keys.device)
    a = torch.erf(lower / sqrt2)
    b = torch.erf(upper / sqrt2)
    u = uniform(keys, shape, dtype, minval=a, maxval=b)
    out = sqrt2 * torch.erfinv(u)
    inf = torch.tensor(math.inf, dtype=dtype, device=keys.device)
    return torch.clamp(out, torch.nextafter(lower, inf),
                       torch.nextafter(upper, -inf))

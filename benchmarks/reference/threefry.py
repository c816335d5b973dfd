"""Plain reference of the counter-based random streams the sampler keys
its draws with: ``jax.random``'s threefry2x32 with its default
partitionable layout, written out in torch integer ops.  A key is an
int64 tensor (..., 2) of two 32-bit words.  Frozen copy of the
algorithm; nothing here imports the program."""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    rotl = lambda x, d: ((x << d) | (x >> (32 - d))) & M32  # noqa: E731
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROT[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def key(seed, device=None):
    seed = int(seed)
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & M32
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(keys, num=2):
    return fold_in(keys[..., None, :],
                   torch.arange(num, dtype=torch.int64, device=keys.device))


def _bits(keys, n):
    """Two 32-bit words per counter 0..n-1 of every key: (..., n) each."""
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    return torch.broadcast_tensors(*threefry2x32(
        keys[..., 0, None], keys[..., 1, None], i >> 32, i & M32))


def unit(keys, n, dtype):
    """Uniform [0, 1) draws, n per key, with the mantissa construction of
    ``jax.random.uniform``: (..., n); n = 0 gives one draw of shape (...)."""
    b1, b2 = _bits(keys, max(n, 1))
    if dtype == torch.float64:
        f = ((b1 << 20) | (b2 >> 12)).to(torch.float64) * 2.0 ** -52
    elif dtype == torch.float32:
        f = ((b1 ^ b2) >> 9).to(torch.float32) * 2.0 ** -23
    else:
        raise TypeError(f"draws are float32 or float64, not {dtype}")
    return f[..., 0] if n == 0 else f


def uniform(keys, n, dtype, lo=0.0, hi=1.0):
    lo = torch.as_tensor(lo, dtype=dtype, device=keys.device)
    hi = torch.as_tensor(hi, dtype=dtype, device=keys.device)
    return torch.maximum(lo, unit(keys, n, dtype) * (hi - lo) + lo)


def truncated_normal(keys, lower, upper, dtype):
    """One standard normal draw truncated to (lower, upper) per entry of
    the bounds (..., n), by the inverse CDF."""
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=keys.device)
    a = torch.erf(lower / sqrt2)
    b = torch.erf(upper / sqrt2)
    out = sqrt2 * torch.erfinv(uniform(keys, lower.shape[-1], dtype, a, b))
    inf = torch.tensor(math.inf, dtype=dtype, device=keys.device)
    return torch.clamp(out, torch.nextafter(lower, inf),
                       torch.nextafter(upper, -inf))

"""The sampler's random streams on the card: Threefry kernels.

The plain versions are the torch integer ops of
:mod:`pysurfinv_tpu_torch.inversion.random` and ``mcmc._draw``, one
kernel launch an op on the card (~170 a hash).  Here each call is one
launch of a CUDA C++ kernel (``csrc/draw_lanes.cu``, per-lane arithmetic
in ``csrc/draw_lane.cuh``), bitwise equal to the plain version on the
card:

  ==================  ===================================================
  wrapper             computes
  ==================  ===================================================
  ``draw_round``      a retry round: each lane's key walked ``W`` splits,
                      and the ``(W, M, P)`` candidates drawn from the
                      subkeys (``mcmc._draw``)
  ``fold_in``         ``random.fold_in`` of keys with an int or a tensor
  ``split``           ``random.split`` (the ``fold_in`` kernel, counted
                      in ``fold_in.launches``)
  ``random_bits``     ``random.random_bits`` of 32 or 64 bits
  ==================  ===================================================

These are the kernel side of :mod:`.random` and ``mcmc._draw_round``,
which dispatch on the device of the keys; the wrappers take CUDA tensors
only and raise on anything else.  The library is built and loaded the
first time a CUDA key is drawn from, so a run that never draws never
builds it.  Each kernel counts its launches in its wrapper's
``.launches`` (``KERNELS``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from pysurfinv_tpu_torch.ops._cuda_build import _launched, build_library

SOURCES = ("draw_lane.cuh", "draw_lanes.cu")
_M32 = 0xFFFFFFFF


def bind(lib):
    """Set the entry points' argument types on a loaded library."""
    P, I, U, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                   ctypes.c_longlong)
    lib.draw_round_launch.argtypes = [P] * 7 + [I, I, I, I, I, P]
    lib.fold_in_launch.argtypes = [P, I, P, U, I, P, LL, P]
    lib.bits_launch.argtypes = [P, LL, P, P, LL, P]
    for fn in (lib.draw_round_launch, lib.fold_in_launch, lib.bits_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def draw_library():
    """Build (once per source hash) and load the draw kernels: ``(lib,
    info)`` as ``_cuda_build.build_library`` returns them."""
    lib, info = build_library("draw_lanes", SOURCES, "draw_lanes.cu")
    return bind(lib), info


def _keys(name, keys):
    if not keys.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs CUDA keys (got "
                         f"{keys.device}); CPU keys take the plain version")
    if keys.dtype != torch.int64 or keys.shape[-1:] != (2,):
        raise TypeError(f"{name}: keys must be int64 (..., 2), got "
                        f"{keys.dtype} {tuple(keys.shape)}")
    return keys.contiguous()


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def draw_round(keys, theta, step, vmin, vmax, W, n_pert):
    """One retry round of every lane: ``keys`` (M, 2) walked ``W`` splits
    (``split`` key 0 carries on, key 1 feeds the draw) and the ``(W, M,
    P)`` candidates, draw ``w`` a truncated-normal perturbation of
    ``theta`` (``mcmc.truncated_step``) while ``w < n_pert`` and a uniform
    reset (``mcmc.uniform_reset``) after.  ``theta``, ``step``, ``vmin``,
    ``vmax``: (M, P) of float32 or float64.  Returns (keys, candidates).
    """
    keys = _keys("draw_round", keys)
    M, P = theta.shape
    if keys.shape != (M, 2):
        raise ValueError(f"draw_round: keys must be ({M}, 2), got "
                         f"{tuple(keys.shape)}")
    if theta.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"draw_round: draws are float32 or float64, got "
                        f"{theta.dtype}")
    rows = [x.contiguous() for x in (theta, step, vmin, vmax)]
    for x in rows:
        if x.dtype != theta.dtype or x.shape != (M, P) \
                or x.device != keys.device:
            raise TypeError(f"draw_round: theta and its bounds must be "
                            f"{theta.dtype} ({M}, {P}) on {keys.device}")
    if not 1 <= W or not 0 <= n_pert <= W:
        raise ValueError(f"draw_round: need W >= 1 and 0 <= n_pert <= W, "
                         f"got W={W}, n_pert={n_pert}")
    lib, _ = draw_library()
    keys_out = torch.empty_like(keys)
    cand = torch.empty((W, M, P), dtype=theta.dtype, device=keys.device)
    err = lib.draw_round_launch(
        keys.data_ptr(), *(x.data_ptr() for x in rows), keys_out.data_ptr(),
        cand.data_ptr(), M, P, int(W), int(n_pert),
        int(theta.dtype == torch.float64), _stream(keys))
    _launched("draw_round", err)
    draw_round.launches += 1
    return keys_out, cand


def fold_in(keys, data):
    """``random.fold_in`` on the card: ``data`` an int (a kernel argument)
    or an integer tensor broadcast against ``keys.shape[:-1]``."""
    keys = _keys("fold_in", keys)
    lead = keys.shape[:-1]
    if torch.is_tensor(data):
        lead = torch.broadcast_shapes(lead, data.shape)
        d = data.to(device=keys.device, dtype=torch.int64)
        d = d.expand(lead).contiguous()
        d_ptr, data0 = d.data_ptr(), 0
    else:
        d_ptr, data0 = None, int(data) & _M32
    if keys.shape[:-1] == lead:
        k_step = 1
    elif keys.numel() == 2:
        k_step = 0
    else:
        keys, k_step = keys.expand(lead + (2,)).contiguous(), 1
    lib, _ = draw_library()
    out = torch.empty(lead + (2,), dtype=torch.int64, device=keys.device)
    err = lib.fold_in_launch(keys.data_ptr(), k_step, d_ptr, data0, 0,
                             out.data_ptr(), math.prod(lead), _stream(keys))
    _launched("fold_in", err)
    fold_in.launches += 1
    return out


def split(keys, num=2):
    """``random.split`` on the card: (..., num, 2)."""
    keys = _keys("split", keys)
    lib, _ = draw_library()
    out = torch.empty(keys.shape[:-1] + (num, 2), dtype=torch.int64,
                      device=keys.device)
    err = lib.fold_in_launch(keys.data_ptr(), 1, None, 0, int(num),
                             out.data_ptr(), out.numel() // 2, _stream(keys))
    _launched("split", err)
    fold_in.launches += 1
    return out


def random_bits(keys, bit_width, shape):
    """``random.random_bits`` on the card: ``b1 ^ b2`` for 32 bits, the
    pair ``(hi, lo)`` for 64."""
    if bit_width not in (32, 64):
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    keys = _keys("random_bits", keys)
    shape = tuple(shape)
    full = keys.shape[:-1] + shape
    lib, _ = draw_library()
    out = torch.empty((bit_width // 32,) + full, dtype=torch.int64,
                      device=keys.device)
    lo = out[1].data_ptr() if bit_width == 64 else None
    err = lib.bits_launch(keys.data_ptr(), math.prod(shape),
                          out[0].data_ptr(), lo, out[0].numel(),
                          _stream(keys))
    _launched("random_bits", err)
    random_bits.launches += 1
    return out[0] if bit_width == 32 else (out[0], out[1])


KERNELS = (draw_round, fold_in, random_bits)
for _k in KERNELS:
    _k.launches = 0


def reset_launch_counts():
    for fn in KERNELS:
        fn.launches = 0

"""The least time the H100 could take for the secular-lane work of a
solve, counted per launch from the launch's own inputs.

Peaks: NVIDIA's H100 SXM data sheet at 700 W, 3.35 TB/s of HBM and 67
TFLOP/s of FP32 outside the tensor cores.  Work: each (c, T) lane
applies the Dunkin (Rayleigh) or Haskell (Love) layer update to every
layer above its closure (mm - 1 layers, read off the launch's truncation
input, or its output for the dynamic sweep); an applied layer costs 182
FP32 operations for Rayleigh and 41 for Love, the dynamic truncation
walk 3 (Rayleigh) or 15 (Love) more; a dual evaluation carries two
tangents and counts 4x.  Bytes: the seven (L, B) model arrays read once,
each lane's inputs read and outputs written once.  The counts follow the
recurrences and the inputs, not any kernel's code, so another kernel
that does the same work reads the same count.  (Frozen from the port's
smoke test, where they were counted off the lane code.)
"""

from __future__ import annotations

from contextlib import contextmanager

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_LAYER = {"rayleigh": 182, "love": 41}
WALK_OPS_PER_LAYER = {"rayleigh": 3, "love": 15}
DUAL_FACTOR = 4
# per lane: 4-byte inputs + outputs of each entry point
LANE_IO = {"secular_lanes": 7, "secular_lanes_frozen": 4,
           "secular_lanes_grad": 6, "refine_lanes": 6}
ENTRY_POINTS = tuple(LANE_IO)


def evaluations(name, n_ill=0, n_newton=0):
    """Secular evaluations a lane of one launch makes, duals weighted."""
    return {"secular_lanes": 1, "secular_lanes_frozen": 1,
            "secular_lanes_grad": DUAL_FACTOR,
            "refine_lanes": n_ill + 2 + n_newton * DUAL_FACTOR}[name]


def launch_work(name, wave, K, B, L, applied, n_ill=0, n_newton=0):
    """(FP32 operations, bytes) of one launch that applies ``applied``
    layer steps over its K x B lanes."""
    wave = "love" if wave in ("love", "lov", "L") else "rayleigh"
    per = OPS_PER_LAYER[wave] + (WALK_OPS_PER_LAYER[wave]
                                 if name == "secular_lanes" else 0)
    ops = applied * per * evaluations(name, n_ill, n_newton)
    nbytes = 7 * L * B * 4 + LANE_IO[name] * K * B * 4 + (
        B * 4 if name == "secular_lanes" else 0)
    return ops, nbytes


def bound_s(ops, nbytes):
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


class Launches:
    """Records every launch of the four entry points while
    :meth:`instrument` is on: the lanes' applied layer steps are summed
    on the device and read once the window has closed."""

    def __init__(self):
        self.calls = []

    @contextmanager
    def instrument(self, module):
        """Wrap the entry points where ``module`` (the port's
        ``ops.dispersion``) binds them."""
        saved = {n: getattr(module, n) for n in ENTRY_POINTS}

        def wrap(name, fn):
            def call(*args, **kw):
                out = fn(*args, **kw)
                c, mm_in = args[0], args[3] if name == "refine_lanes" else args[2]
                mm = out[2] if name == "secular_lanes" else mm_in
                L = args[4 if name == "refine_lanes" else 3].shape[0]
                applied = (mm.long() - 1).clamp(0, L - 1).sum()
                self.calls.append((name, kw.get("wave", "rayleigh"),
                                   c.shape[0], c.shape[1], L, applied,
                                   kw.get("n_ill", 0), kw.get("n_newton", 0)))
                return out
            return call

        for n, fn in saved.items():
            setattr(module, n, wrap(n, fn))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(module, n, fn)

    def totals(self):
        """(FP32 operations, sum of per-launch bound seconds)."""
        ops_sum, bound = 0.0, 0.0
        for name, wave, K, B, L, applied, n_ill, n_newton in self.calls:
            ops, nbytes = launch_work(name, wave, K, B, L, float(applied),
                                      n_ill, n_newton)
            ops_sum += ops
            bound += bound_s(ops, nbytes)
        return ops_sum, bound

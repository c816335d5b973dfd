"""Stochastic model parameters carrying MCMC proposal metadata.

Capability spec from the reference pySurfInv's ``brownian.py``:
  * ``BrownianVar(v, vmin, vmax, step)`` — a float whose proposal is a
    Gaussian step of width ``step`` (clipped to half the bound range),
    rejected-until-in-bounds; ``reset()`` draws uniformly in bounds.
  * ``BrownianVarMC(v, ref, width, type, step)`` — bounds re-derived from
    a reference value: abs / abs_pos / rel / rel_pos.

Host-side these behave exactly like the reference (float subclasses, so
YAML round-trips and arithmetic keep working).  ``as_spec`` exports
(v, vmin, vmax, step) for a device-side sampler.
"""

from __future__ import annotations

import random


class BrownianVar(float):
    def __new__(cls, v, vmin=None, vmax=None, step=None):
        return super().__new__(cls, v)

    def __init__(self, v, vmin, vmax, step) -> None:
        step = abs(vmax - vmin) / 2 if step > abs(vmax - vmin) / 2 else step
        self.vmin = vmin
        self.vmax = vmax
        self.step = step

    @property
    def v(self):
        return float(self)

    def _setValue(self, v):
        return BrownianVar(v, self.vmin, self.vmax, self.step)

    def reset(self):
        return self._setValue(random.uniform(self.vmin, self.vmax))

    def move(self):
        # Gaussian proposal, rejected until in bounds (brownian.py:20-27);
        # equivalent in distribution to a truncated normal.
        for _ in range(1000):
            v_new = random.gauss(self.v, self.step)
            if self.vmin < v_new < self.vmax:
                return self._setValue(v_new)
        return self.reset()

    def as_spec(self):
        """(value, vmin, vmax, step) for the device-side sampler."""
        return (self.v, self.vmin, self.vmax, self.step)

    def __repr__(self):
        return (f"v={self.v} vmax={self.vmax} vmin={self.vmin} "
                f"step={self.step}")

    def __str__(self):
        return str(self.v)


class BrownianVarMC(BrownianVar):
    """Bounds re-centred on a reference value (brownian.py:33-68)."""

    def __new__(cls, v, ref=None, width=None, type=None, step=None):
        return float.__new__(cls, v)

    def __init__(self, v, ref=None, width=None, type=None, step=None):
        self._ref = ref
        self._width = width
        self._type = type
        self._step = step

    @property
    def vmin(self):
        r, w = self._ref, self._width
        if self._type == "abs":
            return r - w
        if self._type == "abs_pos":
            return max(r - w, 0)
        if self._type == "rel":
            return r * (1 - w / 100)
        if self._type == "rel_pos":
            return max(r * (1 - w / 100), 0)
        raise ValueError(f"unknown bound type {self._type}")

    @property
    def vmax(self):
        r, w = self._ref, self._width
        if self._type == "abs":
            return r + w
        if self._type == "abs_pos":
            return max(r + w, 0)
        if self._type == "rel":
            return r * (1 + w / 100)
        if self._type == "rel_pos":
            return max(r * (1 + w / 100), 0)
        raise ValueError(f"unknown bound type {self._type}")

    @property
    def step(self):
        half = abs(self.vmax - self.vmin) / 2
        return half if self._step > half else self._step

    def _setValue(self, v):
        return BrownianVarMC(v, self._ref, self._width, self._type,
                             self._step)

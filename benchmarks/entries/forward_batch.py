"""Entry ``forward_batch``: one cold ``surf_forward_batch`` call over a
batch of models per unit, at the solver's default ``SurfConfig``.

Set-up builds the configuration's model with the reference's own model
build (the object API's layout, padded one row past its layers as the
port's solve bench pads it), and ``n_batches`` batches of ``batch``
copies of it on the card, Vs and Vp of every layer scaled by 1 + a
normal jitter of ``jitter`` drawn from the seed; it warms the solve on
each batch once.  Units cycle through the batches; every call's outputs
are kept for the judge.

Traffic keys: ``batch``, ``n_batches``, ``jitter``, ``wave``,
``check_curves`` (curves judged), ``trace_units``.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.tracing import span
from reference import cascadia as RC


def base_model(config):
    """(h, vp, vs, rho, qsinv) numpy (L,) and the real-layer count of the
    configuration's model, L the layer count + 1 rounded up to 8."""
    pt = RC.parse_point(config["setting"], config["local"])
    n = RC.host_profile(pt)[-1]
    return RC.host_profile(pt, L=int(-(-(n + 1) // 8) * 8))


def batches(config, traffic, seed, device):
    """The jittered float32 batches: a list of (h, vp, vs, rho, qsinv),
    each (B, L), and the (B,) int32 real-layer counts."""
    *base, nlay = base_model(config)
    B, nb = int(traffic["batch"]), int(traffic["n_batches"])
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa
    h, vp, vs, rho, qsi = (t(x) for x in base)
    g = torch.Generator(device=device).manual_seed(int(seed))
    jit = 1.0 + float(traffic["jitter"]) * torch.randn(
        (nb, B, h.shape[0]), generator=g, dtype=torch.float32, device=device)
    jit = torch.where(h > 0, jit, torch.ones_like(jit))
    out = []
    for i in range(nb):
        rep = lambda x: x[None].expand(B, -1).contiguous()  # noqa: E731
        out.append((rep(h), (vp * jit[i]).contiguous(),
                    (vs * jit[i]).contiguous(), rep(rho), rep(qsi)))
    return out, torch.full((B,), nlay, dtype=torch.int32, device=device)


class Entry:
    unit_name = "call"

    def __init__(self, config, traffic, seed, device):
        from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig,
                                                        surf_forward_batch)
        self.solve, self.cfg = surf_forward_batch, SurfConfig()
        self.wave = traffic["wave"]
        self.batches, self.nlay = batches(config, traffic, seed, device)
        self.periods = torch.as_tensor(config["periods"], dtype=torch.float32,
                                       device=device)
        self.sync = (torch.cuda.synchronize if str(device).startswith("cuda")
                     else (lambda: None))
        self.calls = []
        for i in range(len(self.batches)):
            self.step(i)
        self.calls.clear()
        self.i = 0

    def step(self, i=None):
        """One call; returns the curves it solved."""
        i = self.i if i is None else i
        b = self.batches[i % len(self.batches)]
        with span("bench.solve"):
            c, u, ok = self.solve(*b, self.periods, self.nlay, wave=self.wave,
                                  cfg=self.cfg)
            self.sync()
        self.calls.append((i % len(self.batches), c, u, ok))
        self.i = i + 1
        return b[0].shape[0]

    def outputs(self):
        return dict(calls=self.calls, batches=self.batches, nlay=self.nlay,
                    periods=self.periods)

    def failed(self, out):
        """Curves of the window with any period unsolved."""
        return int(sum(int((~ok[..., 0]).any(-1).sum())
                       for _, _, _, ok in out["calls"]))

    def close(self):
        self.calls, self.batches = [], []

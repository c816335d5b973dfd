"""Entry ``survey``: the grid sampler of ``invert_grid``, one segment of
Metropolis steps over every (point, chain) lane per unit.

Set-up builds what ``invert_grid`` builds for one call (the points, the
compiled model, the lane stacks, keys from the seed, the sampler's own
solver settings) and runs ``init_fn`` and the segments up to step
``window_from_step``, the first of them holding each chain's cold start
row.  A step's cost grows as the chains leave their start (the posterior
chains' steps cost twice as much at step 400 as at step 10), so the
window starts where its rate is that of a whole chain.  A unit is the
next segment, its rows copied to the host and queued into the streamed
lane compressor, as ``invert_grid`` does.  When the chains reach their length the next
chain set starts from the next keys (lanes offset as a further tile
would be), its start row inside the window.

Traffic keys: ``chains`` per point, ``chain_len``, ``segment`` (steps a
unit), ``window_from_step``, ``priori``, ``wave``, ``check_rows`` /
``check_starts`` (rows and start rows judged), ``trace_units``.  The configuration's ``assumed``
grid gives the points; the seed orders them and keys the chains.
"""

from __future__ import annotations

import numpy as np
import torch

from harness.tracing import span


def grid_locals(config, seed):
    """The points' local values: the configuration's point at the cell
    midpoints of a square lattice over sediment thickness and plate age,
    in an order drawn from the seed (every seed runs the same points)."""
    g = config["assumed"]["grid"]
    n = int(round(g["points"] ** 0.5))
    mid = lambda lo, hi: lo + (hi - lo) * (np.arange(n) + 0.5) / n  # noqa
    sed, age = np.meshgrid(mid(*g["sedthk_km"]), mid(*g["lithoAge_Myr"]))
    out = []
    for k in np.random.default_rng([seed, 1]).permutation(n * n):
        loc = dict(config["local"])
        loc["sedthk"] = float(sed.flat[k])
        loc["lithoAge"] = float(age.flat[k])
        out.append(loc)
    return out


class Entry:
    unit_name = "segment"

    def __init__(self, config, traffic, seed, device):
        from pysurfinv_tpu_torch.convert import spec_from_numpy
        from pysurfinv_tpu_torch.inversion import random as R
        from pysurfinv_tpu_torch.inversion.compiled import (BrownianSpec,
                                                            CompiledModel)
        from pysurfinv_tpu_torch.inversion.mcmc import ChainConfig
        from pysurfinv_tpu_torch.inversion.point import PointCascadia
        from pysurfinv_tpu_torch.parallel import grid
        from pysurfinv_tpu_torch.utils import StreamingLaneCompressor

        self.R, self.Compressor = R, StreamingLaneCompressor
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.locals = grid_locals(config, seed)
        obs = config["observations"]
        points = [PointCascadia(config["setting"], loc, periods=obs["periods"],
                                vels=obs["vels"], uncers=obs["uncers"])
                  for loc in self.locals]
        cm = CompiledModel(points[0].initMod)
        nch = int(traffic["chains"])
        self.nch, self.K = nch, len(points)
        self.n = self.K * nch
        self.chain_len = int(traffic["chain_len"])
        self.seg = int(traffic["segment"])
        specs = [cm.spec_of(p.initMod) for p in points]
        spec = BrownianSpec(*(np.repeat(np.stack([getattr(s, f) for s in specs]),
                                        nch, axis=0)
                              for f in BrownianSpec._fields))
        psi = np.repeat(np.stack([cm.psi_of(p.initMod) for p in points]), nch,
                        axis=0)
        T, c, u, m = (np.repeat(np.stack(a), nch, axis=0) for a in
                      zip(*(p._obs_arrays() for p in points)))
        self.spec, psi_t = spec_from_numpy(tuple(spec), psi, device=device)
        self.ctx = (psi_t, *(torch.as_tensor(a, device=device)
                             for a in (T, c, u, m)))
        self.use_init = torch.as_tensor(np.tile(np.arange(nch) == 0, self.K),
                                        device=device)
        cfg = ChainConfig(chain_len=self.chain_len,
                          priori=bool(traffic["priori"]))
        self.init_fn, self.seg_fn = grid.batched_sampler(
            cm, PointCascadia, cfg, traffic["wave"], grid.mcmc_solver_cfg())
        self.generations = []       # (offset, tracks) per chain set
        self.window_rows = []       # (generation, s0, s1) run in the window
        self._new_chains()
        self.step()                 # the cold start row and its segment
        while self.s < int(traffic["window_from_step"]):
            self.step()
        self.window_rows.clear()

    def _new_chains(self):
        R = self.R
        off = len(self.generations) * self.n
        self.keys = R.fold_in(R.PRNGKey(self.seed),
                              torch.arange(self.n) + off).to(self.device)
        self.carry = self.init_fn(self.keys, self.spec, self.ctx,
                                  self.spec.theta0, self.use_init)
        self.tracks = np.empty((self.n, self.chain_len, 3 + self.spec.theta0
                                .shape[1]), np.float64)
        self.zc = self.Compressor(self.n)
        self.s = 0
        self.generations.append((off, self.tracks))

    def step(self):
        """One segment; returns the Metropolis samples it completed."""
        if self.s >= self.chain_len:
            self.zc.close()
            self._new_chains()
        n_seg = min(self.seg, self.chain_len - self.s)
        with span("bench.segment"):
            carry, rows = self.seg_fn(self.carry, self.keys, self.spec,
                                      self.ctx, self.s, n_seg)
        with span("bench.rows_to_host"):
            host = rows.cpu().numpy()
        s0, self.s = self.s, self.s + n_seg
        with span("bench.compress"):
            self.tracks[:, s0:self.s] = np.moveaxis(host, 0, 1)
            self.zc.feed(self.tracks, s0, self.s)
        self.carry = carry
        self.window_rows.append((len(self.generations) - 1, s0, self.s))
        return self.n * n_seg

    def outputs(self):
        """What the judge reads: the rows of every chain set, which rows
        the window ran, and the inputs the benchmark made."""
        self.zc.close()
        return dict(generations=self.generations, window=self.window_rows,
                    locals=self.locals, n=self.n, nch=self.nch,
                    chain_len=self.chain_len)

    def failed(self, out):
        """Window rows whose solve found no root, or that hold a value
        that is not finite."""
        bad = 0
        for g, s0, s1 in out["window"]:
            rows = out["generations"][g][1][:, s0:s1]
            bad += int((~np.isfinite(rows).all(-1)
                        | (rows[..., 0] >= 88888.0)).sum())
        return bad

    def close(self):
        self.zc.abort()

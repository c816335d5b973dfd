"""Freeze a Model1D's structure; build whole batches of models from
(theta, psi) tensors.

Counterpart of the JAX package's ``inversion/compiled.py``.  The
reference rebuilds Python layer objects for every MCMC proposal
(models.py:192-219, layers.py:64-79).  Here a model's *structure* (layer
types, fine-grid sizes, group layout, which parameters are stochastic)
is frozen once, and everything value-dependent is a function of two
lane-batched tensors:

  * ``thetas`` (N, ntheta) — the stochastic (Brownian) parameters, in
    the reference's ``_brownians`` order (models.py:240-253);
  * ``psis``   (N, npsi)   — the fixed numeric constants that differ
    between grid points (water depth, sediment thickness, lithospheric
    age, topo, ... injected by ``_loadLocalInfo``), so one structure
    serves a whole geographic grid.

Where the JAX package vmaps a per-model function, the lane axis is
written out here: the layer catalog's lane mode
(``models/layers.py``) builds all N grids at once.

On CUDA the prior (:meth:`CompiledModel.isgood`) runs as one CUDA graph
per batch shape: captured at the shape's first call, replayed after.  A
round of the sampler's retry loop then launches one graph instead of
~1,000 small kernels, each the same kernel in the same order, so the
same bits.  CPU tensors run the ops one by one.

Frozen-structure deviations from the reference (as in the JAX package):
  * per-layer fine-grid counts are locked to the initial model's values
    (the reference adapts them to the current H, layers.py:161-173);
  * layers never vanish mid-chain (the reference drops layers whose
    current H < 0.01, models.py:80; the priors mask them instead);
  * the hybrid layer's melt-onset spline merge uses a Hermite bridge.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from pysurfinv_tpu_torch import profiling
from pysurfinv_tpu_torch.inversion import priors as P
from pysurfinv_tpu_torch.models.brownian import BrownianVar
from pysurfinv_tpu_torch.models.layers import OceanMantleHybrid
from pysurfinv_tpu_torch.utils import device_constant

# parm keys that select static structure and never become lane values
_STATIC_KEYS = {"deg", "Conversion"}
# info keys whose numeric values vary per grid point
_INFO_KEYS = ("topo", "lithoAge")
_COLS = ("vs", "vp", "rho", "qs", "qp")
# prior graphs kept per compiled model, the least recently used dropped
# first: the survey's pyramid needs two, the adaptive samplers and the
# parity wrapper's single rows a few more
_GRAPHS_KEPT = 8


class BrownianSpec(NamedTuple):
    """Flattened stochastic-parameter metadata: start values, bounds and
    proposal steps, each (ntheta,) or lane-stacked (N, ntheta)."""

    theta0: torch.Tensor
    vmin: torch.Tensor
    vmax: torch.Tensor
    step: torch.Tensor


def _walk_brownians(layers):
    """Yield (layer_idx, key, list_idx_or_None, var) in _brownians order
    (models.py:240-253)."""
    for li, layer in enumerate(layers):
        for k, v in layer.parm.items():
            if type(v) is list:
                for i, e in enumerate(v):
                    if isinstance(e, BrownianVar):
                        yield li, k, i, e
            elif isinstance(v, BrownianVar):
                yield li, k, None, v


def _is_plain_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and not isinstance(v, BrownianVar)


def _walk_consts(layers):
    """Yield (layer_idx, key, list_idx_or_None, value) for fixed numeric
    parameters (the per-grid-point constants)."""
    for li, layer in enumerate(layers):
        for k, v in layer.parm.items():
            if k in _STATIC_KEYS:
                continue
            if type(v) is list:
                for i, e in enumerate(v):
                    if _is_plain_number(e):
                        yield li, k, i, e
            elif _is_plain_number(v):
                yield li, k, None, v


class CompiledModel:
    """Freeze a Model1D's structure; build lane batches of its models."""

    def __init__(self, model, pad_align=8):
        self.model = model.copy()
        self.info = dict(model.info)
        layers = self.model.layers
        self._slots = list(_walk_brownians(layers))
        self._const_slots = list(_walk_consts(layers))
        self.spec = self.spec_of(self.model)
        self.psi0 = self.psi_of(self.model)
        self.ntheta = len(self._slots)

        # ---- freeze structure off the initial model --------------------
        self._use_ref = bool(self.info.get("refLayer", False))
        self._layers = list(layers) + (
            [self.model._refLayer] if self._use_ref else [])
        self._n_main = len(layers)

        # fine-grid sizes + static group layout from one host build
        self._nfine = []
        grp_nodes, name_nodes = [], []
        hctx = _HostCtx(self.info)
        for layer in self._layers:
            nf = self._static_nfine(layer, hctx)
            self._nfine.append(nf)
            out = layer.seisPropGrids(layersAbove=hctx.layersAbove(),
                                      modelInfo=self.info, nFine=nf)
            hctx.push(layer, [np.asarray(x) for x in out])
            npts = len(np.asarray(out[0]))
            grp_nodes += [layer.prop["Group"]] * npts
            name_nodes += [layer.prop["LayerName"]] * npts
        self.grp_nodes = np.array(grp_nodes)
        self.name_nodes = np.array(name_nodes)
        self._node_counts = [nf + 1 for nf in self._nfine]
        # isgood uses refLayer=False grids (models.py:575)
        self._n_nodes_main = int(sum(self._node_counts[: self._n_main]))
        self._n_nodes = int(sum(self._node_counts))

        # padded layer-stack length for the solver
        n_rows = self._n_nodes - 1  # midpoints across the full stack
        self.L = int(-(-n_rows // pad_align) * pad_align)

        self._grp_ids_main = _codes(self.grp_nodes[: self._n_nodes_main])
        # node -> main-layer index + layer node spans, for the thin-layer
        # (h < 0.01) drop that mirrors seisPropGrids' hLowerLimit
        # compaction (models.py:80)
        starts = np.concatenate(
            [[0], np.cumsum(self._node_counts[: self._n_main])])[:-1]
        self._node_starts_main = starts.astype(np.int64)
        self._node_ends_main = (
            starts + np.array(self._node_counts[: self._n_main]) - 1
        ).astype(np.int64)
        self._layer_of_node_main = np.repeat(
            np.arange(self._n_main, dtype=np.int64),
            self._node_counts[: self._n_main])
        self._n_mantle = max(int(np.sum(
            self.grp_nodes[: self._n_nodes_main] == "mantle")), 1)
        self._consts = {}                 # the prior's tables per device
        self._graphs = OrderedDict()      # the prior's CUDA graphs
        self._pools = {}                  # device -> the pool they share

    # ---- per-point parameter extraction --------------------------------
    def spec_of(self, model) -> BrownianSpec:
        """BrownianSpec of a same-structure model (per-point bounds), as
        float64 numpy arrays (``convert.spec_from_numpy`` moves them)."""
        bs = [s[3] for s in _walk_brownians(model.layers)]
        if hasattr(self, "_slots") and len(bs) != len(self._slots):
            raise ValueError("model structure mismatch (theta size)")
        return BrownianSpec(
            theta0=np.array([float(b) for b in bs], np.float64),
            vmin=np.array([b.vmin for b in bs], np.float64),
            vmax=np.array([b.vmax for b in bs], np.float64),
            step=np.array([b.step for b in bs], np.float64))

    def psi_of(self, model):
        """Fixed-constant vector of a same-structure model (float64)."""
        cs = [s[3] for s in _walk_consts(model.layers)]
        if hasattr(self, "_const_slots") and len(cs) != len(self._const_slots):
            raise ValueError("model structure mismatch (psi size)")
        info = model.info or {}
        extra = [float(info.get(k, 0) or 0) for k in _INFO_KEYS]
        return np.array([float(c) for c in cs] + extra, np.float64)

    @staticmethod
    def _static_nfine(layer, hctx):
        try:
            return layer._nFineLayers(layersAbove=hctx.layersAbove(),
                                      modelInfo=hctx.info)
        except (NotImplementedError, AttributeError, TypeError):
            return 1

    # ------------------------------------------------------------------
    def _psis(self, thetas, psis):
        if psis is None:
            psis = device_constant("psi0", lambda: self.psi0, thetas.dtype,
                                   thetas.device, self._consts)
        return psis.to(thetas).expand(thetas.shape[0], -1)

    def _substitute(self, thetas, psis):
        """Layer parms with Brownians -> theta columns and consts -> psi
        columns, each (N,)."""
        parms = [dict(l.parm) for l in self._layers]
        for p in parms:
            for k, v in list(p.items()):
                if type(v) is list:
                    p[k] = list(v)
        for j, (li, k, ei, _) in enumerate(self._const_slots):
            if ei is None:
                parms[li][k] = psis[:, j]
            else:
                parms[li][k][ei] = psis[:, j]
        for i, (li, k, ei, _) in enumerate(self._slots):
            if ei is None:
                parms[li][k] = thetas[:, i]
            else:
                parms[li][k][ei] = thetas[:, i]
        return parms

    def _info_lanes(self, psis):
        info = dict(self.info)
        nc = len(self._const_slots)
        for ix, k in enumerate(_INFO_KEYS):
            if k in info and info[k] is not None:
                info[k] = psis[:, nc + ix]
        return info

    def build_grids(self, thetas, psis=None, vs_only=False):
        """(N, ntheta) thetas, (N, npsi) psis -> concatenated node grids
        (z, vs, vp, rho, qs, qp), each (N, n_nodes), in the thetas'
        dtype and on their device.

        ``vs_only=True`` skips every layer's ``_calOthers`` (vp/rho/qs/qp
        come back as zeros) — the prior path: no ``_calVs`` reads
        anything but the z/vs context, so z and vs are bitwise those of
        the full build.
        """
        psis = self._psis(thetas, psis)
        parms = self._substitute(thetas, psis)
        info = self._info_lanes(psis)
        ref = torch.zeros(thetas.shape[0], dtype=thetas.dtype,
                          device=thetas.device)
        nc = len(self._const_slots)
        topo = (psis[:, nc + _INFO_KEYS.index("topo")]
                if self.info.get("topo") is not None else ref)
        z_last = -torch.clamp(topo, min=0.0)
        last = {k: ref for k in _COLS}
        crustH = ref
        z_parts, parts = [], {k: [] for k in _COLS}
        for layer, parm, nf in zip(self._layers, parms, self._nfine):
            lay = layer.copy()
            lay.parm = parm
            kwargs = dict(layersAbove=[z_last] + [last[k] for k in _COLS],
                          modelInfo=info, nFine=nf, vs_only=vs_only,
                          lanes=ref)
            if isinstance(lay, OceanMantleHybrid):
                kwargs["crustH"] = crustH
            z1, *cols = lay.seisPropGrids(**kwargs)
            z_abs = z1 + z_last[:, None]
            z_parts.append(z_abs)
            for k, arr in zip(_COLS, cols):
                arr = arr * torch.ones_like(z_abs)
                parts[k].append(arr)
                last[k] = arr[:, -1]
            if layer.prop["Group"] == "crust":
                crustH = crustH + (z_abs[:, -1] - z_last)
            z_last = z_abs[:, -1]
        z = torch.cat(z_parts, dim=1)
        out = {k: torch.cat(v, dim=1) for k, v in parts.items()}
        return (z, *(out[k] for k in _COLS))

    def build_profile_batch(self, thetas, psis=None):
        """(N, ntheta) thetas -> padded solver stacks.

        Returns (h, vp, vs, rho, qsinv), each (N, L), and an (N,) int32
        nlay — the layout ``surf_forward_batch`` takes.  Midpoint
        averaging as in models.py:93-102; thin rows (h <= 0.01, which the
        reference drops, models.py:102) become h = 0 identity rows; the
        halfspace row is replicated into the padding.
        """
        z, vs, vp, rho, qs, _ = self.build_grids(thetas, psis)
        h = torch.diff(z, dim=1)
        mid = lambda x: 0.5 * (x[:, 1:] + x[:, :-1])  # noqa: E731
        vs, vp, rho, qs = mid(vs), mid(vp), mid(rho), mid(qs)
        h = torch.where(h <= 0.01, 0.0, h)
        pad = self.L - h.shape[1]
        hs = lambda x: torch.cat(  # noqa: E731
            [x, x[:, -1:].expand(-1, pad)], dim=1)
        h_p = torch.cat([h, h.new_zeros(h.shape[0], pad)], dim=1)
        nlay = torch.full((h.shape[0],), h.shape[1], dtype=torch.int32,
                          device=h.device)
        return h_p, hs(vp), hs(vs), hs(rho), hs(1.0 / qs), nlay

    # ------------------------------------------------------------------
    def isgood(self, thetas, psis=None):
        """Lane-batched prior (CascadiaOcean.isgood, models.py:571-677):
        (N,) bool.

        CUDA thetas replay the CUDA graph of their batch shape
        (:meth:`_isgood_graph`); CPU thetas, and a shape whose capture
        failed, run the ops of :meth:`_isgood_plain` one by one.  Both
        give the same bits."""
        if thetas.is_cuda:
            ok = self._isgood_graph(thetas, psis)
            if ok is not None:
                return ok
        profiling.count("prior.plain_calls")
        return self._isgood_plain(thetas, psis)

    def _isgood_graph(self, thetas, psis):
        """:meth:`_isgood_plain` as the CUDA graph of the call's shapes,
        dtypes and device: the inputs are copied into the graph's
        buffers, the graph replays, and a copy of its mask comes back, so
        no caller holds graph memory.  A shape's first call warms the ops
        on a side stream and captures them (the ``torch.cuda.graphs``
        recipe).  None where the shape cannot be captured: a layer whose
        lane mode reads the device, or copies from the host."""
        key = tuple(None if x is None else (x.shape, x.dtype, x.device)
                    for x in (thetas, psis))
        if key not in self._graphs:
            self._graphs[key] = self._capture(thetas, psis)
        self._graphs.move_to_end(key)
        while len(self._graphs) > _GRAPHS_KEPT:
            self._graphs.popitem(last=False)
        entry = self._graphs[key]
        if entry is None:
            return None
        graph, th, ps, ok = entry
        th.copy_(thetas)
        if ps is not None:
            ps.copy_(psis)
        graph.replay()
        profiling.count("prior.graph_replays")
        return ok.clone()

    def _capture(self, thetas, psis):
        """(graph, thetas buffer, psis buffer or None, mask) of
        :meth:`_isgood_plain` at these inputs' shapes, or None where its
        ops cannot be captured.  The warm-up runs them twice, the second
        time with CUDA's synchronizing calls made errors, so that a host
        read of a device value or a copy from the host shows before any
        capture begins: a capture that fails part way can leave the
        caching allocator still routing into its pool."""
        dev = thetas.device
        th = thetas.clone()
        ps = None if psis is None else psis.clone()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            mode = torch.cuda.get_sync_debug_mode()
            try:
                with torch.cuda.stream(side):
                    self._isgood_plain(th, ps)        # builds the tables
                    with warnings.catch_warnings():   # "a prototype"
                        warnings.simplefilter("ignore", UserWarning)
                        torch.cuda.set_sync_debug_mode("error")
                    self._isgood_plain(th, ps)
            except RuntimeError:
                return None
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                stream.wait_stream(side)
            if dev not in self._pools:
                self._pools[dev] = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pools[dev],
                                      capture_error_mode="thread_local"):
                    ok = self._isgood_plain(th, ps)
            except RuntimeError:
                # a failed capture leaves its stream current
                torch.cuda.set_stream(stream)
                return None
        profiling.count("prior.graph_captures")
        return graph, th, ps, ok

    def _prior_tables(self, dev):
        """isgood's node masks and index arrays on ``dev``."""
        n = self._n_nodes_main
        g = self.grp_nodes[:n]
        make = lambda key, a: device_constant(  # noqa: E731
            key, lambda: a, None, dev, self._consts)
        return (make("sediment", g == "sediment"),
                make("crust", g == "crust"), make("mantle", g == "mantle"),
                make("grp", self._grp_ids_main),
                make("starts", self._node_starts_main),
                make("ends", self._node_ends_main),
                make("layer_of_node", self._layer_of_node_main))

    def _isgood_plain(self, thetas, psis=None):
        """The prior as torch ops.  They read no device value on the
        host and copy nothing from it once its tables are on the device,
        so a CUDA graph can capture them."""
        n = self._n_nodes_main
        z, vs, *_ = self.build_grids(thetas, psis, vs_only=True)
        z, vs = z[:, :n], vs[:, :n]
        dev = z.device
        sed, crust, mantle, grp, starts, ends, layer_of_node = \
            self._prior_tables(dev)

        # the host path checks the compacted grid (layers with current
        # H < 0.01 removed, models.py:80): nodes of dropped layers take
        # part in no prior
        h_layer = z[:, ends] - z[:, starts]
        keep = (h_layer > 0.01)[:, layer_of_node]

        ok = torch.where(sed & keep, vs >= 0.2, True).all(dim=1)
        ok &= P.group_jumps_positive(vs, grp, keep)
        # non-strict: see models/model1d.py monoNonDecrease
        ok &= P.mono_increase(vs, sed & keep, eps=-1e-12)
        ok &= P.mono_increase(vs, crust & keep, eps=-1e-12)
        ok &= ((vs[:, -1] - vs[:, -2])
               / torch.clamp(z[:, -1] - z[:, -2], min=1e-9)) > 0
        model_type = type(self.model).__name__
        if model_type in ("CascadiaPrism", "CascadiaContinent"):
            ok &= (vs < 4.9).all(dim=1)
        if "Ocean" in model_type:
            meanM = (torch.where(mantle, vs, 0.0).sum(dim=1)
                     / self._n_mantle)
            ok &= P.local_extrema_oscillation_lanes(vs, mantle, 0.1 * meanM)
            ok &= P.no_local_max(vs, mantle)
            # slope prior + CWT oscillation on the mantle sub-grid
            i0 = int(np.argmax(self.grp_nodes[:n] == "mantle"))
            zM, vM = z[:, i0:n], vs[:, i0:n]
            slope = (torch.diff(vM, dim=1)
                     / torch.clamp(torch.diff(zM, dim=1), min=1e-9))
            ok &= slope.min(dim=1).values >= slope[:, 0] * 1.5
            ok &= P.cwt_oscillation_lanes(
                vM, zM, torch.ones(vM.shape[1], dtype=torch.bool,
                                   device=dev), limit=0.3)
        return ok

    def build_profile(self, theta, psi=None):
        """(ntheta,) theta -> one padded (h, vp, vs, rho, qsinv) stack, each
        (L,), and the int nlay (the halfspace is the last real row): the
        batch of one of :meth:`build_profile_batch`."""
        *stack, nlay = self.build_profile_batch(
            theta[None], None if psi is None else psi[None])
        return (*(x[0] for x in stack), int(nlay[0]))

    # ------------------------------------------------------------------
    def forward(self, theta, periods, psi=None, wave="rayleigh", cfg=None):
        """(theta, psi) -> fundamental-mode phase velocities (P,), 0 where
        the solve failed: the single-model ``surf_forward`` in theta's
        dtype, on its device."""
        from pysurfinv_tpu_torch.ops.dispersion import (SurfConfig,
                                                        surf_forward)

        cfg = replace(cfg or SurfConfig(), nmodes=1)
        h, vp, vs, rho, qsinv, nlay = self.build_profile(theta, psi)
        c, _, ok = surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                                wave=wave, cfg=cfg)
        return torch.where(ok[:, 0], c[:, 0], torch.zeros_like(c[:, 0]))


class _HostCtx:
    """Accumulates layersAbove context for the host structure pass."""

    def __init__(self, info):
        self.info = info
        self.z = [-max(info.get("topo", 0) or 0, 0)]
        self.cols = {k: [0.0] for k in _COLS}
        self.grp, self.names = [], []

    def layersAbove(self):
        return [np.array(self.z)] + \
            [np.array(self.cols[k]) for k in _COLS] \
            + [list(self.grp), list(self.names)]

    def push(self, layer, out):
        z1 = np.asarray(out[0], dtype=float) + self.z[-1]
        self.z += list(z1)
        for k, arr in zip(_COLS, out[1:]):
            self.cols[k] += list(np.asarray(arr, dtype=float)
                                 * np.ones_like(z1))
        self.grp += [layer.prop["Group"]] * len(z1)
        self.names += [layer.prop["LayerName"]] * len(z1)


def _codes(strings):
    """Consecutive-run integer codes so boundaries = value changes."""
    codes = np.zeros(len(strings), dtype=np.int64)
    c = 0
    for i in range(1, len(strings)):
        if strings[i] != strings[i - 1]:
            c += 1
        codes[i] = c
    return codes

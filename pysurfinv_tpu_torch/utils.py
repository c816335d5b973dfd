"""Shared utilities: recursive dict transforms, npz writing (whole
arrays, or chain rows deflated lane by lane while the sampler runs),
the lane paths' cached device constants and profile plotting.

Capability spec from the reference pySurfInv's ``utils.py:9-53``.  matplotlib is
imported only inside the plotting helpers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pysurfinv_tpu_torch import profiling

_CONSTANTS: dict = {}


def savez_fast(path, compresslevel=1, **arrays):
    """``np.savez_compressed`` at a chosen deflate level (numpy pins the
    zlib default, level 6).  MCMC chain files are dominated by repeated
    rejected-step rows, which level-1 deflate already collapses.
    ``np.load`` reads the result identically."""
    import zipfile
    from numpy.lib import format as npformat
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED,
                         compresslevel=compresslevel) as zf:
        for name, val in arrays.items():
            with zf.open(name + ".npy", "w", force_zip64=True) as fh:
                npformat.write_array(fh, np.asarray(val),
                                     allow_pickle=True)


def npy_bytes(val, allow_pickle=True):
    """Serialize one array to ``.npy`` bytes (what ``np.savez`` stores
    per entry)."""
    import io
    from numpy.lib import format as npformat
    fh = io.BytesIO()
    npformat.write_array(fh, np.asarray(val), allow_pickle=allow_pickle)
    return fh.getvalue()


def npy_header_bytes(shape, dtype):
    """The ``.npy`` header (magic + dict) for a C-order array of the
    given shape/dtype — the first bytes of the entry ``np.save`` would
    write, with ``array.tobytes()`` following."""
    import io
    from numpy.lib import format as npformat
    fh = io.BytesIO()
    npformat.write_array_header_1_0(
        fh, {"descr": npformat.dtype_to_descr(np.dtype(dtype)),
             "fortran_order": False, "shape": tuple(shape)})
    return fh.getvalue()


class StreamingLaneCompressor:
    """Deflate MCMC chain rows lane by lane while later segments are
    still running.

    The end-of-run npz write is zlib-bound and serial.  This class moves
    the zlib work into the segment loop: one raw-deflate stream per
    (point, chain) lane, fed each committed segment's rows in time order
    (which is the final byte order within a lane, since the reference's
    ``mcTrack`` layout is chain-major: ``point.py:114-121`` concatenates
    each chain's full track).  Per-lane streams end with
    ``Z_FULL_FLUSH`` (byte-aligned, window-independent), so a point's
    entry is assembled at write time by concatenating its lanes'
    compressed chunks and appending a 2-byte final block: no
    recompression.  ``np.load`` reads the result identically to
    ``savez_fast`` output (one valid deflate stream).

    Feeds run on one worker thread; zlib releases the GIL, so the
    compression runs beside the sampler's host loop.  While the counters
    count (:mod:`..profiling`), the worker thread's CPU seconds on each
    item go to the ``compress.busy_s`` counter.
    """

    def __init__(self, n_lanes, level=1):
        import queue
        import threading
        import zlib
        self._zlib = zlib
        self._objs = [zlib.compressobj(level, zlib.DEFLATED, -15)
                      for _ in range(n_lanes)]
        self._chunks = [[] for _ in range(n_lanes)]
        self._q = queue.Queue()
        self._err = None
        self._closed = False
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                buf, s0, s1 = item
                timed = profiling.enabled()
                if timed:
                    c0 = time.thread_time()
                for lane, obj in enumerate(self._objs):
                    # buf is (n_lanes, chainL, w) C-order: the slice is
                    # a contiguous view, zlib consumes it buffer-direct
                    c = obj.compress(buf[lane, s0:s1])
                    if c:
                        self._chunks[lane].append(c)
                if timed:
                    profiling.count("compress.busy_s",
                                    time.thread_time() - c0)
            except Exception as e:  # noqa: BLE001 — surfaced in close()
                self._err = e

    def feed(self, buf, s0, s1):
        """Queue rows [s0:s1) of every lane (buf = the lane-major track
        buffer; the fed region must never be written again)."""
        self._q.put((buf, s0, s1))

    def close(self):
        """Drain the queue and finalize every lane's stream."""
        if not self._closed:
            self._q.put(None)
            self._t.join()
            if self._err is not None:
                raise self._err
            for lane, obj in enumerate(self._objs):
                self._chunks[lane].append(
                    obj.flush(self._zlib.Z_FULL_FLUSH))
            self._closed = True

    def abort(self):
        """Stop the worker without finalizing (error-path cleanup)."""
        if not self._closed:
            self._q.put(None)
            self._t.join()
            self._closed = True

    def lane_chunks(self, lo, hi):
        """Compressed chunks of lanes [lo:hi) (call close() first)."""
        assert self._closed
        out = []
        for lane in range(lo, hi):
            out.extend(self._chunks[lane])
        return out


#: final empty deflate block terminating a concatenated raw stream
DEFLATE_TERMINATOR = b"\x03\x00"


def write_npz_precompressed(path, entries):
    """Write a ``np.load``-compatible npz from already-deflated data.

    ``entries`` is a list of ``(name, raw_size, crc32, parts)`` where
    ``parts`` is a list of compressed byte chunks forming one valid
    deflate stream for the entry named ``name`` (``.npy`` suffix is
    appended here, matching ``np.savez``).  The zip container is
    assembled by hand because :mod:`zipfile` has no public API for
    inserting precompressed data.  DOS timestamps are pinned to the
    epoch (1980-01-01), like ``savez_fast``'s default ``ZipInfo``.
    """
    import struct
    LIMIT = 0xFFFFFFFF - 1
    recs = []
    with open(path, "wb") as f:
        for name, raw_size, crc, parts in entries:
            nb = (name + ".npy").encode()
            csize = sum(len(p) for p in parts)
            off = f.tell()
            if raw_size > LIMIT or csize > LIMIT or off > LIMIT:
                raise OverflowError("zip64 entry in precompressed npz")
            # local file header: sig, extract-version, flags, method,
            # dos time, dos date, crc, csize, usize, namelen, extralen
            f.write(struct.pack("<IHHHHHIIIHH", 0x04034B50, 20, 0, 8,
                                0, 0x21, crc, csize, raw_size,
                                len(nb), 0))
            f.write(nb)
            for p in parts:
                f.write(p)
            recs.append((nb, raw_size, crc, csize, off))
        cd0 = f.tell()
        for nb, raw_size, crc, csize, off in recs:
            # central directory: sig, made-by, extract-version, flags,
            # method, time, date, crc, csize, usize, namelen, extralen,
            # commentlen, disk#, int attrs, ext attrs, local offset
            f.write(struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 20,
                                20, 0, 8, 0, 0x21, crc, csize,
                                raw_size, len(nb), 0, 0, 0, 0, 0, off))
            f.write(nb)
        cd_size = f.tell() - cd0
        # end of central directory
        f.write(struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, len(recs),
                            len(recs), cd_size, cd0, 0))


def deflate_bytes(data, level=1):
    """One-shot raw deflate of ``data`` -> (crc32, [stream bytes])."""
    import zlib
    obj = zlib.compressobj(level, zlib.DEFLATED, -15)
    return zlib.crc32(data), [obj.compress(data) + obj.flush()]


def device_constant(key, make, dtype, device, cache=_CONSTANTS):
    """The fixed table ``make()`` (numpy) as a tensor of ``dtype`` on
    ``device``, built at the first call for (key, dtype, device) and
    kept in ``cache`` (the module's own, or an owner's for tables of one
    object) for every later one: a lane path's constants, so that a call
    copies nothing from the host (a CUDA graph capture refuses such a
    copy).  Callers never write into the result."""
    k = (key, dtype, torch.device(device))
    t = cache.get(k)
    if t is None:
        t = cache[k] = torch.as_tensor(make(), dtype=dtype, device=device)
    return t


def _dictIterModifier(d, checker, modifier):
    """Recursively walk dicts/lists, replacing values that pass ``checker``.

    The workhorse behind YAML<->Brownian conversion and perturbation
    (utils.py:9-30 of the reference).
    """
    if type(d) is dict:
        out = {}
        for k, v in d.items():
            if checker(v):
                out[k] = modifier(v)
            elif type(v) in (dict, list):
                out[k] = _dictIterModifier(v, checker, modifier)
            else:
                out[k] = v
        return out
    if type(d) is list:
        out = []
        for v in d:
            if checker(v):
                out.append(modifier(v))
            elif type(v) in (dict, list):
                out.append(_dictIterModifier(v, checker, modifier))
            else:
                out.append(v)
        return out
    return d


def plotLayer(h, v, fig=None, ax=None, label=None, **kwargs):
    """Staircase profile plot from layer thicknesses (utils.py:32-42)."""
    import matplotlib.pyplot as plt
    if ax is None:
        fig = plt.figure(figsize=[5, 7])
        ax = plt.gca()
    else:
        plt.sca(ax)
    h = np.asarray(h)
    v = np.asarray(v)
    hNew = np.insert(np.repeat(np.cumsum(h), 2)[:-1], 0, 0)
    vNew = np.repeat(v, 2)
    ax.plot(vNew, hNew, label=label, **kwargs)
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax


def plotGrid(zdepth, v, fig=None, ax=None, label=None, **kwargs):
    """Grid-point profile plot (utils.py:44-53)."""
    import matplotlib.pyplot as plt
    if ax is None:
        fig = plt.figure(figsize=[5, 7])
        ax = plt.gca()
    else:
        plt.sca(ax)
    ax.plot(np.asarray(v), np.asarray(zdepth), label=label, **kwargs)
    if not ax.yaxis_inverted():
        ax.invert_yaxis()
    return ax

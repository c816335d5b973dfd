"""Shared utilities: recursive dict transforms, npz writing and profile
plotting.

Capability spec from the reference pySurfInv's ``utils.py:9-53``.  matplotlib is
imported only inside the plotting helpers.
"""

from __future__ import annotations

import numpy as np


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

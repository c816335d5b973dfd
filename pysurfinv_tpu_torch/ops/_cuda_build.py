"""Build, load and dispatch of the port's CUDA C++ kernel libraries.

Shared by the solver's kernels (:mod:`.secular_lanes`) and the sampler's
draw kernels (:mod:`.draw_lanes`): each builds its ``csrc/`` sources with
nvcc into a library of its own at first use and loads it with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# --fmad=false: no fused multiply-adds, so a kernel performs the plain
# version's IEEE operations in the same order.  Where F sits at the f32
# noise floor (c above every layer's Vs, no truncation, ~86 oscillatory
# layers) F's own f32 error reaches ~3e-2 of the column's max |F|
# (plain f32 against plain f64 on the H100); contracted FMAs moved the
# kernel ~1e-3 of that max away from the plain version there, past the
# 1e-4 the two are held to.  No --use_fast_math: its approximate
# expf/sinf move the sign of F near a root.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# where the kernel libraries are built, beside the package (git-ignored)
BUILD_DIR = CSRC.parent.parent / "build" / "pysurfinv_tpu_torch"

_BACKENDS = ("auto", "plain", "kernel")


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for p in cands:
        if p and os.path.exists(p):
            return p
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/ with the CUDA toolkit at first use")


def build_library(name, sources, main):
    """Build ``csrc/<main>`` (which includes the rest of ``sources``) into
    ``lib<name>.so`` once per hash of the sources and ``NVCC_FLAGS``, and
    load it.

    Returns ``(lib, info)`` where ``info`` holds the build seconds (0 when
    the library was already built), the library path and the compiler's
    register/spill report.
    """
    h = hashlib.sha256()
    for src in sources:
        h.update((CSRC / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    so = out_dir / f"lib{name}.so"
    log = out_dir / "build.log"
    seconds = 0.0
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / main)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building csrc/{main}:\n"
                               f"{res.stdout}\n{res.stderr}")
        log.write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    info = {"seconds": seconds, "path": str(so),
            "log": log.read_text() if log.exists() else ""}
    return ctypes.CDLL(str(so)), info


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _resolve(name, backend, x):
    """Whether ``name`` launches its kernel for input ``x``: under
    ``"auto"`` when ``x`` is not on the CPU, always under ``"kernel"``
    (the wrapper then raises on CPU tensors), never under ``"plain"``."""
    if backend not in _BACKENDS:
        raise ValueError(f"{name}: backend must be one of {_BACKENDS}")
    if backend == "plain" or (backend == "auto" and x.device.type == "cpu"):
        return False
    return True

"""Native (C++) host kernels, loaded via ctypes with a NumPy fallback.

The shared library is built on demand with g++ into `<checkout>/.native_build`;
if no compiler is available every entry point falls back to the pure-NumPy
implementation, so the framework never hard-depends on the toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "mesh_kernels.cpp")
_LIB = None
_TRIED = False


def _build_dir() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    root = os.path.dirname(os.path.dirname(os.path.dirname(_SRC)))
    d = os.path.join(root, ".native_build", f"native-{tag}")
    os.makedirs(d, exist_ok=True)
    return d


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("FVENS_TPU_NO_NATIVE"):
        return None
    try:
        d = _build_dir()
        so = os.path.join(d, "libfvens_mesh.so")
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                 "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)

        lib.fvens_greedy_coloring.restype = ctypes.c_int64
        lib.fvens_greedy_coloring.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.uint8, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
        ]
        lib.fvens_pairwise_aggregate.restype = ctypes.c_int64
        lib.fvens_pairwise_aggregate.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.float64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
        ]
        lib.fvens_greedy_partition.restype = None
        lib.fvens_greedy_partition.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
        ]
        _LIB = lib
    except Exception as e:  # pragma: no cover - toolchain-dependent
        print(f"fvens_tpu.native: falling back to NumPy kernels ({e})",
              file=sys.stderr)
        _LIB = None
    return _LIB


def available() -> bool:
    """Whether the C++ kernels loaded (else the NumPy fallbacks run)."""
    return _load() is not None


def greedy_coloring_native(cell_nbrs, nbr_mask, active):
    """Returns (color (n,) int64, n_colors) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n, maxnf = cell_nbrs.shape
    color = np.empty(n, dtype=np.int64)
    nc = lib.fvens_greedy_coloring(
        n, maxnf,
        np.ascontiguousarray(cell_nbrs, dtype=np.int32),
        np.ascontiguousarray(nbr_mask, dtype=np.float64),
        np.ascontiguousarray(active, dtype=np.uint8),
        color)
    return color, int(nc)


def pairwise_aggregate_native(nbrs, mask, w, n_real):
    """Returns (agg (n_real,) int64, n_agg) or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    maxnf = nbrs.shape[1]
    agg = np.empty(n_real, dtype=np.int64)
    na = lib.fvens_pairwise_aggregate(
        n_real, maxnf,
        np.ascontiguousarray(nbrs[:n_real], dtype=np.int64),
        np.ascontiguousarray(mask[:n_real], dtype=np.float64),
        np.ascontiguousarray(w[:n_real], dtype=np.float64),
        agg)
    return agg, int(na)


def greedy_partition_native(esuel, nfael, nparts):
    lib = _load()
    if lib is None:
        return None
    nelem, maxnf = esuel.shape
    part = np.empty(nelem, dtype=np.int64)
    lib.fvens_greedy_partition(
        nelem, maxnf,
        np.ascontiguousarray(esuel, dtype=np.int64),
        np.ascontiguousarray(nfael, dtype=np.int64),
        nparts, part)
    return part

"""ctypes bindings for the native C++ design engine (twin of
``gaussian_process_optimization_tpu/utils/native.py``; the source is this
package's ``csrc/gpo_native.cpp``).

Compiled at first use with ``g++`` (the JAX package's flags, ``-O3 -std=c++17
-shared -fPIC``) into ``_build/`` under a name keyed by a hash of the source and
the flags, written atomically, so an edit rebuilds and parallel first uses do not
clash. Every entry point has a numpy fallback in ``bo/designs.py``, taken when
there is no compiler or ``GPO_TPU_NO_NATIVE`` is set (the JAX package's switch).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "gpo_native.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LIB = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libgpo_native_{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    if not SOURCE.exists():
        return None
    lib = library_path()
    if lib.exists():
        return lib
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            out = Path(tmp) / lib.name
            subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(out)], check=True,
                           capture_output=True, timeout=120)
            os.replace(out, lib)  # atomic: a concurrent loader sees all or nothing
        return lib
    except (OSError, subprocess.SubprocessError):  # no g++, or it failed or hung
        return None


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("GPO_TPU_NO_NATIVE"):
        return None
    lib_path = _build()
    if lib_path is None:
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    lib.min_pairwise_dist.restype = ctypes.c_double
    lib.min_pairwise_dist.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
    ]
    lib.maximin_lhs.restype = None
    lib.maximin_lhs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.discrete_lhs.restype = ctypes.c_int
    lib.discrete_lhs.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_double, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.sobol_points.restype = ctypes.c_int
    lib.sobol_points.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "native engine unavailable (no compiler or GPO_TPU_NO_NATIVE set); "
            "check utils.native.available() and use the numpy fallbacks in "
            "bo/designs.py")
    return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def maximin_lhs(n, d, iterations, seed) -> np.ndarray:
    """The best of ``iterations`` random LHS designs in [0, 1]^d by minimum
    pairwise distance (pyDOE criterion='maximin'), ``(n, d)``."""
    lib = _require_lib()
    out = np.empty((n, d), dtype=np.float64)
    lib.maximin_lhs(n, d, iterations, int(seed) & 0xFFFFFFFFFFFFFFFF, _dptr(out))
    return out


def discrete_lhs(n, levels, iterations, retries, frac, seed):
    """Returns (unit_starts (n, d), representation_ok)."""
    lib = _require_lib()
    levels = np.asarray(levels, dtype=np.int32)
    d = len(levels)
    out = np.empty((n, d), dtype=np.float64)
    ok = lib.discrete_lhs(
        n, d, iterations, retries,
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        float(frac), int(seed) & 0xFFFFFFFFFFFFFFFF, _dptr(out),
    )
    return out, bool(ok)


def sobol_points(n, d) -> np.ndarray | None:
    """The first ``n`` unscrambled Sobol points in [0, 1]^d; None past d = 16."""
    lib = _require_lib()
    out = np.empty((n, d), dtype=np.float64)
    if not lib.sobol_points(n, d, _dptr(out)):
        return None
    return out


def min_pairwise_dist(X) -> float:
    lib = _require_lib()
    X = np.ascontiguousarray(X, dtype=np.float64)
    return float(lib.min_pairwise_dist(_dptr(X), X.shape[0], X.shape[1]))

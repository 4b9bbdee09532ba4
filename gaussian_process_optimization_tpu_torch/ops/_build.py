"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library lands in
``_build/`` under a name keyed by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the last build. Nothing is fetched:
``nvcc`` comes from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``.

Every entry point returns ``cudaGetLastError()`` after its launch, or, having
launched nothing, :data:`SMEM_DOES_NOT_FIT`; :func:`check` raises on a non-zero
code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argtypes; every function returns int (a cudaError_t)
_K_COMMON = [_I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _I, _I, _P]
_SIGNATURES = {
    "gpo_bwd_partial_rows": [_I, _I, _I, _I],
    "gpo_bwd_col_strip": [],
    "gpo_padded_width": [_I],
    "gpo_cholesky_blocks": [_P, _P, _I, _I, _P],
    "gpo_chol_full_diag": [_P, _L, _I, _I, _P, _P, _P, _I, _P],
    "gpo_chol_full_nan": [_P, _L, _P, _I, _P],
    "gpo_chol_full_syrk": [_P, _L, _I, _I, _I, _P, _I, _I, _I, _P],
    "gpo_stationary_k": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _P],
    "gpo_stationary_k_bwd_rows": [_P, _P, _P, _P, _P, _P, *_K_COMMON],
    "gpo_stationary_k_bwd_cols": [_P, _P, _P, _P, _P, *_K_COMMON],
    "gpo_sum_partials": [_P, _P, _I, _I, _L, _P],
    "gpo_tri_inv_blocks": [_P, _P, _I, _I, _P],
}

# What an entry point returns when one thread block would need more shared
# memory than the device lets it opt in to (``csrc/block_smem.cuh``).
SMEM_DOES_NOT_FIT = -1

_lib = None


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpo_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists.
    ``nvcc``'s register and shared-memory report goes to ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in _sources() if s.suffix == ".cu"]
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]

        def compile_one(src, obj):
            t0 = time.perf_counter()
            done = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return done, f"# {src.name}: compiled in {time.perf_counter() - t0:.2f} s\n"

        with ThreadPoolExecutor(len(cu)) as pool:  # one nvcc per source, side by side
            done = list(pool.map(compile_one, cu, objs))
        logs = [took + d.stdout for d, took in done]
        failed = [(src.name, d.returncode, d.stdout)
                  for src, (d, _) in zip(cu, done) if d.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({code}):\n{log}" for name, code, log in failed))
        tmp_out = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_out),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
        os.replace(tmp_out, out)  # atomic: a concurrent loader sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code == SMEM_DOES_NOT_FIT:
        raise ValueError(f"{what}: the block size needs more shared memory than a "
                         "thread block can have on this device")
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")

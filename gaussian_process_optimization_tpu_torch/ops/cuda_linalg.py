"""CUDA kernels for batched diagonal blocks (twin of
``gaussian_process_optimization_tpu/ops/pallas_linalg.py``).

Two kernels replace the JAX package's two Pallas kernels there (``_make_entry``
/ ``_run_blocks`` with ``_make_triinv_kernel`` and ``_make_chol_kernel``):

- :func:`tri_inv_blocks` (``csrc/tri_inv.cu``) — the inverse of every
  ``(nb, nb)`` lower-triangular block of a ``(..., nb, nb)`` stack in one launch.
  Each thread block owns one 32-column strip of one lane's inverse and walks it
  in 32 x 32 tile rows (blocked forward substitution).
- :func:`cholesky_blocks` (``csrc/chol_blocks.cu``) — the Cholesky factor of
  every ``(nb, nb)`` block in one launch. One thread block owns one lane and
  factors its lower triangle, kept in shared memory as 32 x 32 tiles (144 KB at
  nb = 256), panel by panel. A lane whose factorization meets a non-positive
  pivot comes out all NaN.

Routing is the reference's gate (``_make_entry``): square blocks, ``nb`` a
multiple of 32, float32. A CUDA tensor that passes it launches the kernel or
raises (a ``ValueError`` when its tiles do not fit a block's shared memory,
which the kernel's C entry checks before it launches); anything else,
and every CPU tensor, takes the plain version beside the kernel: a triangular
solve against the identity, and ``cholesky_ex`` with the lanes it reports as
failed set to NaN (the reference's fallback, XLA's Cholesky, returns NaN there).
Launches are counted in ``utils.profiling.counters``: ``b3.launches`` and
``b4.launches``.
"""
from __future__ import annotations

import torch

from ..config import kernels_enabled
from ..utils.profiling import counters
from . import _build

_MB = 32  # tile edge of the kernels; the gate's block multiple


def tri_inv_plain(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(A)
    return L.masked_fill_((info != 0)[..., None, None], float("nan"))


def _eligible(A: torch.Tensor) -> bool:
    nb = A.shape[-1]
    return (kernels_enabled(A) and A.ndim >= 2 and nb == A.shape[-2]
            and nb % _MB == 0 and nb >= _MB and A.dtype == torch.float32)


def _flat(A: torch.Tensor, nb: int) -> torch.Tensor:
    """``A`` as a contiguous (G, nb, nb) stack whose data start on 16 bytes,
    as the kernels' vector loads need."""
    flat = A.reshape(-1, nb, nb).contiguous()
    return flat if flat.data_ptr() % 16 == 0 else flat.clone()


def tri_inv_blocks(A: torch.Tensor) -> torch.Tensor:
    """Inverse of each lower-triangular ``(nb, nb)`` block of ``A (..., nb, nb)``.
    The strict upper triangle of the result is exactly zero."""
    if not (A.is_cuda and _eligible(A)):
        return tri_inv_plain(A)
    nb = A.shape[-1]
    flat = _flat(A, nb)
    out = torch.empty_like(flat)
    if flat.shape[0]:
        lib = _build.library()
        _build.check(lib.gpo_tri_inv_blocks(
            flat.data_ptr(), out.data_ptr(), flat.shape[0], nb,
            torch.cuda.current_stream().cuda_stream), "tri_inv_blocks")
        counters["b3.launches"] += 1
    return out.reshape(A.shape)


def cholesky_blocks(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of each symmetric positive-definite ``(nb, nb)`` block of
    ``A (..., nb, nb)``, lower, with an exactly zero strict upper triangle. A
    lane that is not positive definite comes out all NaN."""
    if not (A.is_cuda and _eligible(A)):
        return cholesky_plain(A)
    nb = A.shape[-1]
    flat = _flat(A, nb)
    out = torch.empty_like(flat)
    if flat.shape[0]:
        lib = _build.library()
        _build.check(lib.gpo_cholesky_blocks(
            flat.data_ptr(), out.data_ptr(), flat.shape[0], nb,
            torch.cuda.current_stream().cuda_stream), "cholesky_blocks")
        counters["b4.launches"] += 1
    return out.reshape(A.shape)

"""CUDA kernels for batched diagonal blocks (twin of
``gaussian_process_optimization_tpu/ops/pallas_linalg.py``), and the batched
full-size Cholesky.

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

A third, :func:`chol_full` (B5, ``csrc/chol_full.cu``), replaces no Pallas
kernel: it factors whole ``(..., n, n)`` float32 matrices, the jitter ladder's
full-size attempts, which the JAX package leaves to XLA and the port otherwise to
cuSOLVER (``cholesky_ex``). It is a right-looking blocked factorization over
panels of 128 columns: per panel one launch factors every lane's diagonal block
and writes its inverse, one batched float32 product forms the panel, and two
launches update the trailing matrix's lower triangle, the next panel's tile
column on a high-priority stream beside the diagonal work, the rest on the
caller's stream. Its verdict is stricter than LAPACK's positive pivot: a
pivot must be finite and above 8 sqrt(n) units of rounding times its column's
diagonal entry (:func:`pivot_floors`), below which cuSOLVER's rounding may turn
a pivot negative. Its gate
(:func:`chol_full_eligible`): CUDA float32, square, ``n`` a multiple of 128 and
at least 512; a CUDA tensor outside it raises. :func:`chol_full_plain` is the
same algorithm in plain PyTorch, and :func:`chol_full`'s route for CPU tensors.
Each factorization counts one ``b5.launches``.
"""
from __future__ import annotations

import functools
import math

import torch

from ..config import kernels_enabled
from ..utils.profiling import counters
from . import _build

_MB = 32  # tile edge of the kernels; the gate's block multiple
_NB = 128  # B5's panel width and trailing-update tile edge (csrc/chol_full.cu: kNB)
# B5's smallest n, four panels. At two, the sparse example's inducing-point Gram
# (M = 256, cond far past 1 / u) took rung 3 where cholesky_ex takes 1 (the
# plain version in float32), and its VarDTC bound read 5.65e-3 from float64 on
# an H100 (chip_smoke.py's limit 1e-3; about 4e-4 through cholesky_ex); at such
# n cuSOLVER's time is mostly its launches
_MIN_N = 4 * _NB
# B5's pivot floor over sqrt(n) u, relative to the column's diagonal entry
_PIVOT_FLOOR = 8


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


def pivot_floors(A: torch.Tensor) -> torch.Tensor:
    """B5's verdict: the floor each pivot of ``A (..., n, n)`` must pass, as a
    contiguous (..., n) tensor: 8 sqrt(n) u (u = eps / 2, the rounding of a sum
    of n products) times the same column's diagonal entry, 512 u = 3.05e-5 in
    float32 at n = 4096. A pivot below it is within the rounding of the sum it
    is left from, and cuSOLVER's potrf, whose test is LAPACK's (positive),
    takes or fails such a pivot by its rounding. On an H100, on the thesis
    Gower Ky at n = 4096 (singular in float64 without jitter), every lane's
    smallest pivot read 1.24e-5 to 1.39e-5 of its diagonal entry at rung 2,
    where ``cholesky_ex`` failed the posterior's and passed the fit's lanes,
    and 1.21e-4 to 1.29e-4 at rung 3 on every route; over the Matern52 cell's
    ladder calls the smallest read 2.0e-4."""
    n = A.shape[-1]
    u = torch.finfo(A.dtype).eps / 2
    return (_PIVOT_FLOOR * math.sqrt(n) * u) * torch.diagonal(A, dim1=-2, dim2=-1)


def chol_full_plain(A: torch.Tensor) -> torch.Tensor:
    """B5's algorithm in plain PyTorch, for any square ``A (..., n, n)``: per
    panel of 128 columns the diagonal block's Cholesky (:func:`cholesky_plain`)
    and inverse, the panel as a product with that inverse, and the trailing
    update. B5's verdict: a lane fails where a pivot (a squared diagonal entry
    of L) is not both finite and above its floor (:func:`pivot_floors`), and
    comes out all NaN; the strict upper triangle is exactly zero."""
    n = A.shape[-1]
    floors = pivot_floors(A)
    L = A.clone(memory_format=torch.contiguous_format)
    failed = torch.zeros(A.shape[:-2], dtype=torch.bool, device=A.device)
    for k0 in range(0, n, _NB):
        k1 = min(k0 + _NB, n)
        Lkk = cholesky_plain(L[..., k0:k1, k0:k1])
        piv = torch.diagonal(Lkk, dim1=-2, dim2=-1).square()
        failed |= ~((piv > floors[..., k0:k1]) & torch.isfinite(piv)).all(dim=-1)
        L[..., k0:k1, k0:k1] = Lkk
        if k1 < n:
            L21 = L[..., k1:, k0:k1] @ tri_inv_plain(Lkk).mT
            L[..., k1:, k0:k1] = L21
            L[..., k1:, k1:] -= L21 @ L21.mT
    return torch.tril(L).masked_fill_(failed[..., None, None], float("nan"))


def chol_full_eligible(A: torch.Tensor) -> bool:
    """Whether :func:`chol_full` launches B5 for ``A``."""
    n = A.shape[-1]
    return (A.is_cuda and kernels_enabled(A) and A.ndim >= 2 and A.shape[-2] == n
            and n % _NB == 0 and n >= _MIN_N and A.dtype == torch.float32)


def chol_full(A: torch.Tensor, overwrite_a: bool = False) -> torch.Tensor:
    """Cholesky factor of each symmetric positive-definite matrix of
    ``A (..., n, n)``, lower, from A's lower triangle, with an exactly zero
    strict upper triangle. A lane that fails B5's verdict (:func:`pivot_floors`)
    comes out all NaN, and only such a lane holds a non-finite entry. With
    ``overwrite_a`` the factor may take A's memory. A CPU tensor takes
    :func:`chol_full_plain`; a CUDA tensor outside :func:`chol_full_eligible`
    raises, and its caller chooses the factorization, as the jitter ladder
    does."""
    if not A.is_cuda:
        return chol_full_plain(A)
    if not chol_full_eligible(A):
        raise ValueError(
            f"chol_full: B5 takes CUDA float32 (..., n, n) with n a multiple of {_NB} and at "
            f"least {_MIN_N}, with the kernels on; got {A.dtype} {tuple(A.shape)}")
    n = A.shape[-1]
    L = A.reshape(-1, n, n)
    if not (overwrite_a and L.is_contiguous() and L.data_ptr() % 16 == 0):
        L = L.clone(memory_format=torch.contiguous_format)
    G = L.shape[0]
    if G:
        _chol_full_panels(L)
        counters["b5.launches"] += 1
    return L.reshape(A.shape)


@functools.cache
def _lookahead_stream(device_index: int) -> torch.cuda.Stream:
    """One high-priority stream a device for B5's lookahead. Each stream that
    the panel product runs on takes its own cuBLAS workspace; a fresh stream
    from PyTorch's pool each call held 32 of them, 1 GiB on an H100."""
    return torch.cuda.Stream(device_index, priority=-1)


def _chol_full_panels(L: torch.Tensor) -> None:
    """B5's launches on a contiguous CUDA float32 (G, n, n) L, in place, with a
    lookahead: each panel's diagonal block, its product and the next panel's
    tile column of the trailing update go to a high-priority stream, the rest
    of the update to the caller's, so that the next diagonal block is factored
    while the bulk of the update runs. Events order the two; the caller's
    stream waits for both at the end."""
    G, n = L.shape[0], L.shape[-1]
    lib = _build.library()
    main = torch.cuda.current_stream(L.device)
    crit = _lookahead_stream(L.device.index)
    crit.wait_stream(main)
    Linv = torch.empty(G, _NB, _NB, dtype=L.dtype, device=L.device)
    failed = torch.empty(G, dtype=torch.int32, device=L.device)
    rest_done = None

    def update(W, k0, head, stream):
        _build.check(lib.gpo_chol_full_syrk(L.data_ptr(), n * n, n, k0, _NB, W.data_ptr(),
                                            n - k0 - _NB, head, G, stream.cuda_stream),
                     "chol_full")

    with torch.cuda.stream(crit):
        floors = pivot_floors(L)  # read before the first panel overwrites the diagonal
        for k0 in range(0, n, _NB):
            _build.check(lib.gpo_chol_full_diag(L.data_ptr(), n * n, n, k0, Linv.data_ptr(),
                                                floors.data_ptr(), failed.data_ptr(), G,
                                                crit.cuda_stream),
                         "chol_full")
            if k0 + _NB == n:
                break
            W = torch.matmul(Linv, L[:, k0 + _NB:, k0:k0 + _NB].mT).contiguous()  # L_21^T
            W_ready = crit.record_event()
            if rest_done is not None:  # the next tile column took the last update too
                crit.wait_event(rest_done)
            update(W, k0, 1, crit)
            main.wait_event(W_ready)
            W.record_stream(main)
            update(W, k0, 0, main)
            rest_done = main.record_event()
        if rest_done is not None:
            crit.wait_event(rest_done)
        _build.check(lib.gpo_chol_full_nan(L.data_ptr(), n * n, failed.data_ptr(), G,
                                           crit.cuda_stream), "chol_full")
    main.wait_stream(crit)

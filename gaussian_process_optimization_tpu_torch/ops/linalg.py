"""Dense linear algebra for exact GP inference (twin of ``gaussian_process_optimization_tpu/ops/linalg.py``).

Every function takes leading lane axes. Triangular solves are
``torch.linalg``'s. The jitter ladder factors each attempt with ``cholesky_ex``,
or with :func:`blocked_cholesky` (its diagonal blocks in the batched Cholesky
kernel) when ``config.cuda_chol_blocks`` is on; the diagonal blocks of
:func:`tri_inv_lower` route into the triangular-inverse kernel
(``ops/cuda_linalg.py``).
"""
from __future__ import annotations

import torch

from ..config import config
from . import cuda_linalg


def symmetrify(A: torch.Tensor) -> torch.Tensor:
    """Exact symmetry by copying the lower triangle (GPy util/linalg.py:356)."""
    return torch.tril(A) + torch.tril(A, -1).transpose(-1, -2)


def tri_tdot(Li: torch.Tensor, nb: int = 512) -> torch.Tensor:
    """Li^T Li for lower-triangular Li, blocked so only nonzero panels multiply
    (the LAPACK ``lauum`` shape). Exactly symmetric by construction."""
    n = Li.shape[-1]
    if n < 2 * nb:
        return symmetrify(Li.transpose(-1, -2) @ Li)
    W = torch.zeros_like(Li)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        blk = Li[..., k0:, k0:k1].transpose(-1, -2) @ Li[..., k0:, k0:]
        W[..., k0:k1, k0:] = blk
        if k1 < n:  # mirror into the strictly-lower block area
            W[..., k1:, k0:k1] = blk[..., :, k1 - k0:].transpose(-1, -2)
    return W


def blocked_cholesky(A: torch.Tensor, nb: int = 256) -> torch.Tensor:
    """Blocked left-looking Cholesky (LAPACK ``potrf`` blocking) as a panel loop
    of batched ops (the reference's ``blocked_cholesky``, linalg.py:38-91): per
    panel, the Schur-updated diagonal block's Cholesky (the batched kernel when
    ``config.cuda_chol_blocks``), a triangular solve for the panel below it, and
    matmul updates. A lane whose diagonal block fails is NaN from that block on,
    through the solves and updates, and in no other lane. Below ``2 * nb`` the
    whole matrix takes the plain factorization."""

    def diag_chol(blk):
        if config.cuda_chol_blocks:
            return cuda_linalg.cholesky_blocks(blk)
        return cuda_linalg.cholesky_plain(blk)

    n = A.shape[-1]
    if n < 2 * nb:
        return cuda_linalg.cholesky_plain(A)
    L = torch.zeros_like(A)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        Akk = A[..., k0:k1, k0:k1]
        if k0 > 0:
            Lrow = L[..., k0:k1, :k0]
            Akk = Akk - Lrow @ Lrow.transpose(-1, -2)
        Lkk = diag_chol(Akk)
        L[..., k0:k1, k0:k1] = Lkk
        if k1 < n:
            Ap = A[..., k1:, k0:k1]
            if k0 > 0:
                Ap = Ap - L[..., k1:, :k0] @ L[..., k0:k1, :k0].transpose(-1, -2)
            # X Lkk^T = Ap
            L[..., k1:, k0:k1] = torch.linalg.solve_triangular(
                Lkk.transpose(-1, -2), Ap, upper=True, left=False)
    return L


def jitchol_full(A: torch.Tensor, k_start=None, greedy: bool = False):
    """Jitter-ladder Cholesky, per lane: ``(L, jitter, ok, rung)``.

    GPy's ladder (util/linalg.py:56-74) tries jitter 0, then mean(diag)*1e-6,
    multiplied by 10 each retry, and keeps the first success. Success is
    monotone in the jitter, so the reference (``_jitchol_loop``) finds the same
    minimal rung by a galloping binary search from the hint ``k_start``; this is
    that search, with a lane axis carrying each lane's own interval.
    ``greedy=True`` is the reference's fit-trial policy: each lane walks up from
    its hint and keeps its first success, which may lie above the minimal rung.

    Each attempt is one factorization of every lane: ``blocked_cholesky`` when
    ``config.cuda_chol_blocks`` is on (itself ``cholesky_ex`` below two
    256-blocks), else ``cholesky_ex``. The per-lane verdict is finiteness, as in the
    reference, because both routes return a failed lane as NaN:
    ``cholesky_ex`` itself reports a non-PD lane through ``info > 0`` and may
    return an L that is entirely finite (``diag(1, 1, -1e-3, 1)`` factors to a
    finite L with info = 3), so ``cholesky_plain`` sets such lanes to NaN.

    Failed lanes (even the largest jitter fails) report ok=False,
    rung = config.jitchol_maxtries + 1, and the last attempt's L and jitter.
    """
    maxtries = config.jitchol_maxtries
    batch = A.shape[:-2]
    dev = A.device
    diag_mean = torch.diagonal(A, dim1=-2, dim2=-1).mean(-1)
    factor = blocked_cholesky if config.cuda_chol_blocks else cuda_linalg.cholesky_plain

    def attempt(k):
        scale = torch.pow(10.0, torch.clamp(k - 1, min=0).to(A.dtype))
        jitter = torch.where(k == 0, torch.zeros_like(diag_mean),
                             diag_mean * config.jitchol_base * scale)
        Aj = A.clone()
        Aj.diagonal(dim1=-2, dim2=-1).add_(jitter[..., None])
        L = factor(Aj)
        del Aj
        ok = torch.isfinite(L).all(dim=-1).all(dim=-1)
        L.masked_fill_(~ok[..., None, None], float("nan"))
        return L, jitter, ok

    if k_start is None:
        h = torch.zeros(batch, dtype=torch.int64, device=dev)
    else:
        h = torch.as_tensor(k_start, device=dev, dtype=torch.float64)
        h = torch.clamp(torch.floor(torch.nan_to_num(h)).to(torch.int64), 0, maxtries)
        h = h.expand(batch).clone()
    L_b, j_b, ok_b = attempt(h)

    if greedy:
        k = h
        done = ok_b | (h >= maxtries)
        while not bool(done.all()):
            k = torch.where(done, k, k + 1)
            L, jitter, ok = attempt(k)
            take = ~done  # a searching lane records its success or its latest failure
            L_b = torch.where(take[..., None, None], L, L_b)
            del L
            j_b = torch.where(take, jitter, j_b)
            ok_b = ok_b | (take & ok)
            done = done | (take & ok) | (k >= maxtries)
        return L_b, j_b, ok_b, torch.where(ok_b, k, torch.full_like(k, maxtries + 1))

    lo = torch.where(ok_b, torch.zeros_like(h), h + 1)
    hi = torch.where(ok_b, h, torch.full_like(h, maxtries))
    done = (ok_b & (lo == hi)) | (lo > hi)
    step = torch.ones_like(lo)
    while not bool(done.all()):
        # galloping probe: downward from hi once a success is in hand,
        # upward from lo (lo, lo+1, lo+3, ...) before
        mid = torch.where(ok_b, torch.maximum(lo, hi - step),
                          torch.minimum(hi, lo + step - 1))
        L, jitter, ok = attempt(mid)
        succ = ~done & ok
        fail = ~done & ~ok
        # record on success, or on failure while no success is in hand (so an
        # all-fail lane reports its last attempt, at rung maxtries)
        take = succ | (fail & ~ok_b)
        L_b = torch.where(take[..., None, None], L, L_b)
        del L
        j_b = torch.where(take, jitter, j_b)
        ok_b = ok_b | succ
        hi = torch.where(succ, mid, hi)
        lo = torch.where(fail, mid + 1, lo)
        done = done | (ok_b & (lo == hi)) | (lo > hi)
        step = step * 2
    rung = torch.where(ok_b, hi, torch.full_like(hi, maxtries + 1))
    return L_b, j_b, ok_b, rung


def _expand_rhs(L, B):
    batch = torch.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    return L.expand(batch + L.shape[-2:]), B.expand(batch + B.shape[-2:])


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L x = B, L lower triangular (GPy dtrtrs lower=1)."""
    L, B = _expand_rhs(L, B)
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_lower_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^T x = B, L lower triangular (dtrtrs trans=1)."""
    L, B = _expand_rhs(L, B)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=True)


def blocked_solve_lower(L: torch.Tensor, B: torch.Tensor, nb: int = 512) -> torch.Tensor:
    """Forward substitution as a panel loop: n/nb batched (nb, nb) solves plus a
    panel matvec each. Same arithmetic as the full solve; the full solve is used
    for small n or a wide right-hand side."""
    n = L.shape[-1]
    if n < 2 * nb or B.shape[-1] > nb:
        return solve_lower(L, B)
    L, B = _expand_rhs(L, B)
    x = torch.zeros_like(B)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        rhs = B[..., k0:k1, :]
        if k0 > 0:
            rhs = rhs - L[..., k0:k1, :k0] @ x[..., :k0, :]
        x[..., k0:k1, :] = torch.linalg.solve_triangular(L[..., k0:k1, k0:k1], rhs,
                                                         upper=False)
    return x


def tri_inv_lower(L: torch.Tensor, block: int = 256) -> torch.Tensor:
    """L^-1 for lower-triangular L by divide and conquer: invert the diagonal
    ``block`` blocks in one batched call (the triangular-inverse kernel when
    ``config.cuda_tri_inv``), then merge up a log-depth tree of matmuls with
    [[A, 0], [C, D]]^-1 = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]."""

    def diag_inv(blk):
        if config.cuda_tri_inv:
            return cuda_linalg.tri_inv_blocks(blk)
        return cuda_linalg.tri_inv_plain(blk)

    n = L.shape[-1]
    if n <= block:
        return cuda_linalg.tri_inv_plain(L)
    nblk = -(-n // block)
    levels = max(0, (nblk - 1).bit_length())
    n_pad = block * (1 << levels)
    if n_pad != n:  # pad to a power-of-two multiple of block, identity diagonal
        Lp = torch.zeros(L.shape[:-2] + (n_pad, n_pad), dtype=L.dtype, device=L.device)
        Lp[..., :n, :n] = L
        Lp.diagonal(dim1=-2, dim2=-1)[..., n:] = 1.0
        L = Lp
    nblk = n_pad // block
    diag = torch.stack([L[..., i * block:(i + 1) * block, i * block:(i + 1) * block]
                        for i in range(nblk)], dim=-3)
    inv = diag_inv(diag)
    s = block
    while s < n_pad:
        g = inv.shape[-3]
        Ai, Di = inv[..., 0::2, :, :], inv[..., 1::2, :, :]
        C = torch.stack([L[..., (2 * i + 1) * s:(2 * i + 2) * s, 2 * i * s:(2 * i + 1) * s]
                         for i in range(g // 2)], dim=-3)
        Bk = -(Di @ (C @ Ai))
        top = torch.cat([Ai, torch.zeros_like(Bk)], dim=-1)
        bot = torch.cat([Bk, Di], dim=-1)
        inv = torch.cat([top, bot], dim=-2)
        s *= 2
    out = inv[..., 0, :, :]
    return out[..., :n, :n] if n_pad != n else out


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 sum(log(diag(L)))."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def masked_gram(K: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Rows/cols where mask == 0 replaced by identity rows (pad-safe Gram)."""
    if mask is None:
        return K
    m = mask.to(K.dtype)
    return K * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)

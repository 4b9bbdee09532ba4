"""Dense linear algebra for exact GP inference (twin of ``gaussian_process_optimization_tpu/ops/linalg.py``).

Every function takes leading lane axes. Triangular solves are
``torch.linalg``'s. The jitter ladder factors each attempt with ``cholesky_ex``,
or with :func:`blocked_cholesky` (its diagonal blocks in the batched Cholesky
kernel) when ``config.cuda_chol_blocks`` is on; the diagonal blocks of
:func:`tri_inv_lower` route into the triangular-inverse kernel
(``ops/cuda_linalg.py``). :func:`matmul` takes the reference's ``precision``
argument, which the exact GP's backward passes to :func:`tri_tdot` and
:func:`tri_inv_lower` (``config.grad_matmul_precision``).
"""
from __future__ import annotations

import torch

from ..config import config
from . import cuda_linalg


def tdot(X: torch.Tensor) -> torch.Tensor:
    """X X^T, exactly symmetric (GPy tdot_blas, util/linalg.py:299)."""
    return symmetrify(X @ X.transpose(-1, -2))


def symmetrify(A: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """Exact symmetry by copying the lower triangle, or with ``upper`` the
    upper one (GPy util/linalg.py:356)."""
    if upper:
        return torch.triu(A) + torch.triu(A, 1).transpose(-1, -2)
    return torch.tril(A) + torch.tril(A, -1).transpose(-1, -2)


def _split_bf16(A: torch.Tensor):
    """A = hi + lo + O(2^-16 |A|): the bf16 high part and the bf16 rounding of
    what it leaves."""
    hi = A.to(torch.bfloat16)
    return hi, (A - hi.to(A.dtype)).to(torch.bfloat16)


def _mm_bf16(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A product of bf16 operands with float32 output. On the card, cuBLAS's
    bf16 GEMM accumulating in float32 (``out_dtype``); elsewhere the parts
    upcast and multiplied in float32. A bf16 x bf16 product is exact in
    float32, so the two differ only in the order of summation."""
    if not A.is_cuda:
        return A.float() @ B.float()
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    if not batch:
        return torch.mm(A, B, out_dtype=torch.float32)
    A3 = A.expand(batch + A.shape[-2:]).reshape((-1,) + A.shape[-2:])
    B3 = B.expand(batch + B.shape[-2:]).reshape((-1,) + B.shape[-2:])
    out = torch.bmm(A3, B3, out_dtype=torch.float32)
    return out.reshape(batch + out.shape[-2:])


def matmul(A: torch.Tensor, B: torch.Tensor, precision=None) -> torch.Tensor:
    """A @ B at the reference's ``precision`` (``jnp.matmul(..., precision=)``).
    None or "highest": the plain product. For float32 operands, "high" is
    bf16x3 (hi hi + hi lo + lo hi over each operand's two bf16 parts, ~16
    mantissa bits, the TPU's 'high') and "default" one bf16 pass (the TPU's
    default, ~8 bits); other dtypes ignore the precision, as JAX on the CPU
    does."""
    if not _in_bf16(precision, A.dtype):
        return A @ B
    return _bf16_passes(*_split_bf16(A), *_split_bf16(B), precision)


def _in_bf16(precision, dtype) -> bool:
    """Whether products at ``precision`` split operands of ``dtype`` into
    bf16 parts."""
    if precision in (None, "highest") or dtype != torch.float32:
        return False
    if precision not in ("high", "default"):
        raise ValueError(f"precision {precision!r}: None, 'highest', 'high' or 'default'")
    return True


def _bf16_passes(Ah, Al, Bh, Bl, precision):
    """The products of split operands: hi hi + hi lo + lo hi ("high") or
    hi hi alone ("default")."""
    if precision == "default":
        return _mm_bf16(Ah, Bh)
    return (_mm_bf16(Ah, Bl) + _mm_bf16(Al, Bh)) + _mm_bf16(Ah, Bh)


def tri_tdot(Li: torch.Tensor, nb: int = 512, precision=None) -> torch.Tensor:
    """Li^T Li for lower-triangular Li, blocked so only nonzero panels multiply
    (the LAPACK ``lauum`` shape). Exactly symmetric by construction. Each
    product at ``precision`` (:func:`matmul`; Li is split into its bf16 parts
    once, not once a panel)."""
    n = Li.shape[-1]
    if n < 2 * nb:
        return symmetrify(matmul(Li.transpose(-1, -2), Li, precision))
    split = _in_bf16(precision, Li.dtype)
    if split:
        Lh, Ll = _split_bf16(Li)
    W = torch.zeros_like(Li)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        if split:
            blk = _bf16_passes(Lh[..., k0:, k0:k1].transpose(-1, -2),
                               Ll[..., k0:, k0:k1].transpose(-1, -2),
                               Lh[..., k0:, k0:], Ll[..., k0:, k0:], precision)
        else:
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


def jitchol_full(A: torch.Tensor, maxtries: int | None = None, k_start=None,
                 greedy: bool = False):
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
    rung = maxtries + 1, and the last attempt's L and jitter. ``maxtries``
    defaults to ``config.jitchol_maxtries``.
    """
    if maxtries is None:
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


class _JitChol(torch.autograd.Function):
    """The ladder's L with the Cholesky pullback (the reference's
    ``_jitchol_bwd``, linalg.py:271-287): A_bar = (S + S^T) / 2 with
    S = L^-T Phi(L^T L_bar) L^-1, Phi the lower triangle with a halved
    diagonal. The jitter the ladder chose is held constant."""

    @staticmethod
    def forward(ctx, A, maxtries, k_start, greedy):
        L, jitter, ok, rung = jitchol_full(A, maxtries, k_start=k_start, greedy=greedy)
        ctx.save_for_backward(L)
        ctx.mark_non_differentiable(jitter, ok, rung)
        return L, jitter, ok, rung

    @staticmethod
    def backward(ctx, L_bar, *_):
        (L,) = ctx.saved_tensors
        return cholesky_pullback(L, L_bar), None, None, None


def cholesky_pullback(L: torch.Tensor, L_bar: torch.Tensor) -> torch.Tensor:
    """A_bar of L = chol(A) given L_bar: (S + S^T) / 2 with
    S = L^-T Phi(L^T L_bar) L^-1, Phi the lower triangle with a halved diagonal."""
    W = torch.tril(L.transpose(-1, -2) @ L_bar)
    W.diagonal(dim1=-2, dim2=-1).mul_(0.5)
    Lt = L.transpose(-1, -2)
    tmp = torch.linalg.solve_triangular(Lt, W, upper=True)
    S = torch.linalg.solve_triangular(Lt, tmp.transpose(-1, -2), upper=True)
    S = S.transpose(-1, -2)
    return 0.5 * (S + S.transpose(-1, -2))


def jitchol(A: torch.Tensor, maxtries: int | None = None, k_start=None,
            greedy: bool = False):
    """``(L, jitter, ok)`` of the jitter ladder (GPy jitchol, util/linalg.py:56-74),
    differentiable in ``A`` through the Cholesky pullback."""
    L, jitter, ok, _ = _JitChol.apply(A, maxtries, k_start, greedy)
    return L, jitter, ok


def jitchol_f64(A: torch.Tensor) -> torch.Tensor:
    """The lower factor of :func:`jitchol` computed in float64 and rounded to
    ``A``'s dtype (differentiable through both casts): for B = I + W^1/2 K
    W^1/2 of EP and Laplace, whose diagonal reaches W_ii K_ii ~ 1e3-1e4 while
    its trailing pivots are ~1, so that a float32 factorization loses 3-4
    digits in each."""
    return jitchol(A.double())[0].to(A.dtype)


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


def tri_inv_lower(L: torch.Tensor, block: int = 256, precision=None) -> torch.Tensor:
    """L^-1 for lower-triangular L by divide and conquer: invert the diagonal
    ``block`` blocks in one batched call (the triangular-inverse kernel when
    ``config.cuda_tri_inv``), then merge up a log-depth tree of matmuls with
    [[A, 0], [C, D]]^-1 = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]. ``precision``
    reaches the merge products only, as in the reference: its diagonal-block
    kernel and its small-n solve run at full precision."""

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
        Bk = -matmul(Di, matmul(C, Ai, precision), precision)
        top = torch.cat([Ai, torch.zeros_like(Bk)], dim=-1)
        bot = torch.cat([Bk, Di], dim=-1)
        inv = torch.cat([top, bot], dim=-2)
        s *= 2
    out = inv[..., 0, :, :]
    return out[..., :n, :n] if n_pad != n else out


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(L L^T) x = B given the lower Cholesky factor (GPy dpotrs, util/linalg.py:116)."""
    return solve_lower_t(L, solve_lower(L, B))


def dpotri(L: torch.Tensor) -> torch.Tensor:
    """The inverse of A = L L^T from its Cholesky factor (GPy dpotri, util/linalg.py:127)."""
    return tri_tdot(tri_inv_lower(L))


def pdinv(A: torch.Tensor, maxtries: int | None = None):
    """(A^-1, L, L^-1, logdet) for symmetric positive definite A (GPy pdinv,
    util/linalg.py:193)."""
    L, _, _ = jitchol(A, maxtries)
    Li = tri_inv_lower(L)
    return tri_tdot(Li), L, Li, logdet_from_chol(L)


def backsub_both_sides(L: torch.Tensor, X: torch.Tensor, transpose: str = "left"):
    """L^-T X L^-1 ('left') or L^-1 X L^-T ('right') for lower-triangular L
    (GPy util/linalg.py:381)."""
    if transpose == "left":
        tmp = solve_lower_t(L, X)
        return solve_lower_t(L, tmp.transpose(-1, -2)).transpose(-1, -2)
    tmp = solve_lower(L, X)
    return solve_lower(L, tmp.transpose(-1, -2)).transpose(-1, -2)


def trace_dot(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """trace(A B) without forming the product (GPy util/linalg.py trace_dot)."""
    return torch.sum(A * B.transpose(-1, -2), dim=(-2, -1))


def cholupdate(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rank-1 update chol(L L^T + x x^T) of one ``(n, n)`` factor, by the
    orthogonal Givens form c = Lkk / r, s = xk / r: defined for a semidefinite
    factor too (Lkk == 0 gives c = 0; r == 0 is the identity rotation), where
    GPy's loop (linalg_cython.pyx cholupdate) divides by the pivot."""
    L = L.clone()
    x = x.reshape(-1).clone()
    n = x.shape[0]
    for k in range(n):
        Lkk, xk = L[k, k].clone(), x[k].clone()
        r = torch.sqrt(Lkk * Lkk + xk * xk)
        r_safe = torch.where(r == 0, torch.ones_like(r), r)
        c = torch.where(r == 0, torch.ones_like(r), Lkk / r_safe)
        s = xk / r_safe
        col = L[k + 1:, k].clone()
        L[k + 1:, k] = c * col + s * x[k + 1:]
        x[k + 1:] = c * x[k + 1:] - s * col
        L[k, k] = r
    return L


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    """log|A| = 2 sum(log(diag(L)))."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def masked_gram(K: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Rows/cols where mask == 0 replaced by identity rows (pad-safe Gram)."""
    if mask is None:
        return K
    m = mask.to(K.dtype)
    return K * (m[:, None] * m[None, :]) + torch.diag(1.0 - m)

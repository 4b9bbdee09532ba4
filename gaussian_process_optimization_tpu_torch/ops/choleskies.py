"""Packed-triangular Cholesky utilities (twin of
``gaussian_process_optimization_tpu/ops/choleskies.py``; GPy util/choleskies.py
and choleskies_cython.pyx): flat <-> lower-triangular packing of per-output
Cholesky factors (SVGP's variational covariance) and the Cholesky pullback.
"""
from __future__ import annotations

import numpy as np
import torch


def _tri_indices(m):
    return np.tril_indices(m)


def flat_to_triang(flat, m=None):
    """(num_tri, P) -> (P, M, M) lower triangular (choleskies.py flat_to_triang)."""
    num_tri, p = flat.shape
    if m is None:
        m = int((np.sqrt(8 * num_tri + 1) - 1) / 2)
    rows, cols = _tri_indices(m)
    out = torch.zeros((p, m, m), dtype=flat.dtype, device=flat.device)
    out[:, rows, cols] = flat.mT
    return out


def triang_to_flat(L):
    """(P, M, M) -> (num_tri, P) (choleskies.py triang_to_flat)."""
    rows, cols = _tri_indices(L.shape[-1])
    return L[:, rows, cols].mT


def backprop_gradient(dL, L):
    """dF/dA for A = L L^T, given dF/dL and L (choleskies_cython.pyx:48;
    Murray 2016): S = L^-T Phi(L^T tril(dL)) L^-1, symmetrized; Phi is the
    lower triangle with a halved diagonal."""
    P = torch.tril(L.mT @ torch.tril(dL))
    P = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
    tmp = torch.linalg.solve_triangular(L.mT, P, upper=True)
    S = torch.linalg.solve_triangular(L.mT, tmp.mT, upper=True).mT
    return 0.5 * (S + S.mT)


def indexes_to_fix_for_low_rank(rank, size):
    """Indices of a flat triangular array to hold at zero for a low-rank
    covariance (choleskies.py); the diagonal beyond the rank is kept, as GPy
    keeps it."""
    rows, cols = _tri_indices(size)
    return [i for i, (r, c) in enumerate(zip(rows, cols)) if c >= rank and r != c]

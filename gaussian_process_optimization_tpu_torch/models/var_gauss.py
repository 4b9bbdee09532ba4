"""KL variational Gaussian inference, Opper & Archambeau 2009 (twin of
``gaussian_process_optimization_tpu/models/var_gauss.py``; GPy
inference/latent_function_inference/var_gauss.py).

q(f) = N(m, S) with m = K alpha and S = (K^-1 + diag(W))^-1; ELBO =
E_q[log p(y|f)] - KL(q || N(0, K)), the expectations by Gauss-Hermite. The free
parameters (alpha, log W) go to L-BFGS; S's diagonal and the KL come from one
Cholesky of B = I + W^1/2 K W^1/2.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import lbfgs, linalg


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _posterior_terms(K, alpha, W):
    """(m, diag(S), KL, ok) for q = N(K alpha, (K^-1 + diag(W))^-1)."""
    n = K.shape[0]
    sW = torch.sqrt(torch.clamp(W, min=1e-12))
    L, _, ok = linalg.jitchol(_eye(n, K) + sW[:, None] * K * sW[None, :])
    m = K @ alpha
    # S = K - K sW B^-1 sW K: diag(S) from V = L^-1 sW K
    V = linalg.solve_lower(L, sW[:, None] * K)
    s_diag = torch.clamp(torch.diagonal(K) - torch.sum(torch.square(V), 0), min=1e-12)
    # KL = 0.5 [alpha^T m + tr(B^-1) - n + log|B|]
    Li = linalg.solve_lower(L, _eye(n, K))
    kl = 0.5 * (torch.dot(alpha, m) + torch.sum(torch.square(Li)) - n
                + linalg.logdet_from_chol(L))
    return m, s_diag, kl, ok


def vargauss_elbo(K, y, likelihood, alpha, W, gh_points=20):
    m, s_diag, kl, _ = _posterior_terms(K, alpha, W)
    gh_x, gh_w = np.polynomial.hermite.hermgauss(gh_points)
    gh_x = torch.as_tensor(gh_x, dtype=K.dtype, device=K.device)
    gh_w = torch.as_tensor(gh_w, dtype=K.dtype, device=K.device) / math.sqrt(math.pi)
    f = m[:, None] + torch.sqrt(2.0 * s_diag)[:, None] * gh_x
    return torch.sum(gh_w * likelihood.logpdf(f, y[:, None])) - kl


@dataclasses.dataclass(frozen=True)
class VarGaussPosterior:
    alpha: torch.Tensor = None
    W: torch.Tensor = None
    elbo: torch.Tensor = None


def vargauss_inference(K, y, likelihood, maxiter=200) -> VarGaussPosterior:
    """(alpha, log W) by L-BFGS on -ELBO, from zeros."""
    n = K.shape[0]

    def loss(U):
        return -vargauss_elbo(K, y, likelihood, U[0, :n], torch.exp(U[0, n:])).reshape(1)

    res = lbfgs.minimize(loss, torch.zeros(2 * n, dtype=K.dtype, device=K.device),
                         maxiter=maxiter)
    return VarGaussPosterior(alpha=res.x[:n], W=torch.exp(res.x[n:]), elbo=-res.f)


def vargauss_predict(K_train, Ks, kdiag_s, post: VarGaussPosterior):
    """Latent predictive under q: mu* = Ks^T alpha; var* through the same B."""
    n = K_train.shape[0]
    sW = torch.sqrt(torch.clamp(post.W, min=1e-12))
    L, _, _ = linalg.jitchol(_eye(n, K_train) + sW[:, None] * K_train * sW[None, :])
    V = linalg.solve_lower(L, sW[:, None] * Ks)
    return Ks.mT @ post.alpha, torch.clamp(kdiag_s - torch.sum(torch.square(V), 0), min=1e-15)

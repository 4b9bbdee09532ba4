"""Uncollapsed (SVI) Bayesian GPLVM, minibatch training over N (twin of
``gaussian_process_optimization_tpu/models/bgplvm_svi.py``; GPy
models/bayesian_gplvm_minibatch.py, core/sparse_gp_minibatch.py,
inference/latent_function_inference/var_dtc_parallel.py).

An explicit q(U) = N(m_p, S) per output keeps the data term a sum over points:

    ELBO = sum_n E_{q(x_n) q(U)}[log N(y_n | f_n, beta^-1)]
           - KL(q(U) || p(U)) - KL(q(X) || N(0, I)),

with the uncertain-input moments from the psi statistics. At the optimal q(U)
(:meth:`BGPLVM_SVI.optimal_qU`) it equals the collapsed bound. Training is Adam
on a minibatch estimate (:func:`fit_bgplvm_svi`), set to the reference's optax
update.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..ops import linalg
from .gp import LOG_2_PI
from .gplvm import gaussian_kl, pca_init, rbf_psi_stats_n
from .lvmogp import _eye, _sum_log_diag, _tril_chol, _whiten
from .parameters import make_packer


@dataclasses.dataclass(frozen=True)
class BGPLVM_SVI:
    kern: object = None
    likelihood_variance: torch.Tensor = None
    Z: torch.Tensor = None        # (M, Q)
    q_mu: torch.Tensor = None     # (N, Q)
    q_S: torch.Tensor = None      # (N, Q), positive
    qU_mean: torch.Tensor = None  # (M, P), one mean per output
    qU_A: torch.Tensor = None     # free (M, M); the shared LS = _tril_chol(qU_A)
    Y: torch.Tensor = None        # (N, P)

    @classmethod
    def create(cls, Y, input_dim, num_inducing=10, kernel=None, noise_var=0.1, seed=0,
               dtype=None, device=None) -> "BGPLVM_SVI":
        """PCA means, S = 0.5, Z a seeded subset of the means, q(U) near
        N(0, 0.31^2 I); ``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        Y = np.asarray(Y, dtype=float)
        n, p = Y.shape
        mu0 = pca_init(Y, input_dim)
        rng = np.random.default_rng(seed)
        Z0 = mu0[rng.permutation(n)[:num_inducing]].copy()
        M = Z0.shape[0]
        return cls(kern=kernel or RBF.create(input_dim, ARD=True, **new),
                   likelihood_variance=torch.tensor(float(noise_var), **new),
                   Z=torch.as_tensor(Z0, **new), q_mu=torch.as_tensor(mu0, **new),
                   q_S=torch.full((n, input_dim), 0.5, **new),
                   qU_mean=0.01 * torch.as_tensor(rng.standard_normal((M, p)), **new),
                   qU_A=-torch.eye(M, **new), Y=torch.as_tensor(Y - Y.mean(0), **new))

    def _factors(self):
        M = self.Z.shape[0]
        Lu, _, _ = linalg.jitchol(self.kern.K(self.Z) + 1e-6 * _eye(M, self.Z))
        return Lu, _tril_chol(self.qU_A)

    def data_term(self, Y, mu, S, scale=1.0):
        """``scale`` times the sum over the given rows of E[log N(y_n | f_n,
        beta^-1)] (``scale`` = N / batch for a minibatch, var_dtc_parallel)."""
        beta = 1.0 / (self.likelihood_variance + 1e-8)
        Lu, LS = self._factors()
        nb, p = Y.shape
        _, psi1, psi2n = rbf_psi_stats_n(self.kern, self.Z, mu, S)
        A = linalg.solve_lower(Lu, psi1.transpose(0, 1))
        Mw = linalg.solve_lower(Lu, self.qU_mean)
        LSw = linalg.solve_lower(Lu, LS)
        Sw = LSw @ LSw.transpose(0, 1)
        P2n = _whiten(Lu, psi2n)
        Ef = A.transpose(0, 1) @ Mw
        Ef2 = (torch.einsum("nij,ip,jp->np", P2n, Mw, Mw)
               + torch.einsum("nij,ij->n", P2n, Sw)[:, None])
        resid = self.kern.variance - torch.diagonal(P2n, dim1=1, dim2=2).sum(-1)
        ll = (-0.5 * nb * p * (LOG_2_PI - torch.log(beta))
              - 0.5 * beta * (torch.sum(torch.square(Y)) - 2.0 * torch.sum(Y * Ef)
                              + torch.sum(Ef2) + p * torch.sum(resid)))
        return scale * ll

    def kl_u(self):
        """KL(q(U) || p(U)), the covariance S shared by the P outputs."""
        Lu, LS = self._factors()
        M, p = self.qU_mean.shape
        Mw = linalg.solve_lower(Lu, self.qU_mean)
        LSw = linalg.solve_lower(Lu, LS)
        logdet_ratio = 2.0 * (_sum_log_diag(Lu) - _sum_log_diag(LS))
        return 0.5 * (p * torch.sum(torch.square(LSw)) + torch.sum(torch.square(Mw)) - p * M
                      + p * logdet_ratio)

    def elbo(self):
        return (self.data_term(self.Y, self.q_mu, self.q_S) - self.kl_u()
                - gaussian_kl(self.q_mu, self.q_S))

    def elbo_minibatch(self, idx):
        """Unbiased minibatch estimate: the batch's data term and latent KL
        scaled by N / |batch| (sparse_gp_minibatch's stochastics)."""
        scale = self.Y.shape[0] / idx.shape[0]
        return (self.data_term(self.Y[idx], self.q_mu[idx], self.q_S[idx], scale=scale)
                - self.kl_u() - scale * gaussian_kl(self.q_mu[idx], self.q_S[idx]))

    def log_marginal_likelihood(self):
        return self.elbo()

    def optimal_qU(self):
        """The closed-form optimal q(U) at fixed hyperparameters and q(X); with
        it the uncollapsed bound equals the collapsed one (Titsias)."""
        beta = 1.0 / (self.likelihood_variance + 1e-8)
        M = self.Z.shape[0]
        Kuu = self.kern.K(self.Z) + 1e-6 * _eye(M, self.Z)
        _, psi1, psi2n = rbf_psi_stats_n(self.kern, self.Z, self.q_mu, self.q_S)
        Kinv = torch.linalg.inv(Kuu)
        S_opt = torch.linalg.inv(Kinv + beta * Kinv @ torch.sum(psi2n, dim=0) @ Kinv)
        return beta * S_opt @ Kinv @ (psi1.transpose(0, 1) @ self.Y), S_opt


def fit_bgplvm_svi(model: BGPLVM_SVI, steps=100, batch=16, learning_rate=1e-2,
                   indices=None, generator: np.random.Generator | None = None):
    """Adam on the minibatch -ELBO over every leaf but Y (the reference's optax
    loop; torch's Adam set to optax's update). Step i takes the sorted rows
    ``indices[i]`` if given, else ``batch`` rows drawn without replacement from
    ``generator`` (numpy, seed 0 by default, as the gallery's loop).
    ``(fitted, losses)``."""
    packer = make_packer(model)
    u = packer.pack(model).detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([u], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    rng = generator if generator is not None else np.random.default_rng(0)
    n = model.Y.shape[0]
    losses = []
    for i in range(steps):
        idx = (np.asarray(indices[i]) if indices is not None
               else np.sort(rng.choice(n, size=batch, replace=False)))
        opt.zero_grad(set_to_none=True)
        loss = -packer.unpack(u, reference=model).elbo_minibatch(
            torch.as_tensor(idx, device=model.Y.device))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        return packer.unpack(u.detach(), reference=model), np.asarray(losses)

"""Latent-variable multiple-output GP (twin of
``gaussian_process_optimization_tpu/models/lvmogp.py``; GPy
models/gp_multiout_regression.py, gp_multiout_regression_md.py and
inference/latent_function_inference/vardtc_svi_multiout.py; Dai, Alvarez &
Lawrence 2017).

The outputs are embedded in a latent row space: f(x, d) has the Kronecker
covariance k_c(x, x') k_r(h_d, h_d'). Inference is uncollapsed SVI-VarDTC with
a matrix-variate q(U) (mean M, covariance Sr (x) Sc) and a Gaussian q(H) over
the output coordinates (RBF psi statistics). The ELBO is one expression and
autograd gives every gradient, where the reference derives them by hand.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.transforms import POSITIVE
from .gp import LOG_2_PI
from .gplvm import (gaussian_kl, minimize_one, packer_for, pca_init, rbf_psi_stats,
                    rbf_psi_stats_n)


def _tril_chol(A):
    """A free (M, M) matrix -> a valid Cholesky factor: its strict lower
    triangle and a softplus diagonal."""
    return torch.tril(A, -1) + torch.diag(torch.nn.functional.softplus(torch.diagonal(A)) + 1e-8)


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


def _whiten(L, P):
    """L^-1 P L^-T, over any leading axes of P."""
    return linalg.backsub_both_sides(L, P, "right")


def _factors(m):
    """(Lc, Lr, LSc, LSr): the inducing Grams' factors and q(U)'s."""
    Lc, _, _ = linalg.jitchol(m.kern_c.K(m.Zc) + 1e-6 * _eye(m.Zc.shape[0], m.Zc))
    Lr, _, _ = linalg.jitchol(m.kern_r.K(m.Zr) + 1e-6 * _eye(m.Zr.shape[0], m.Zr))
    return Lc, Lr, _tril_chol(m.qU_Ac), _tril_chol(m.qU_Ar)


def _q_u(m, Lc, Lr, LSc, LSr):
    """(Mt, LcInvLSc, LrInvLSr): q(U)'s mean and factors, whitened."""
    Mt = linalg.solve_lower(Lc, linalg.solve_lower(Lr, m.qU_mean.transpose(0, 1))
                            .transpose(0, 1))
    return Mt, linalg.solve_lower(Lc, LSc), linalg.solve_lower(Lr, LSr)


def _sum_log_diag(L):
    return torch.sum(torch.log(torch.diagonal(L)))


def _create_fields(kernel, kernel_row, X, H0, D, Xr_dim, num_inducing, noise_var, rng, new):
    Mc, Mr = num_inducing
    Zc = X[rng.permutation(X.shape[0])[:Mc]].copy()
    Zr = H0[rng.permutation(D)[:Mr]].copy()
    return dict(
        kern_c=kernel or RBF.create(X.shape[1], **new),
        kern_r=kernel_row or RBF.create(Xr_dim, ARD=True, **new),
        likelihood_variance=torch.tensor(float(noise_var), **new),
        Zc=torch.as_tensor(Zc, **new), Zr=torch.as_tensor(Zr, **new),
        q_Hmu=torch.as_tensor(H0, **new), q_HS=torch.full((D, Xr_dim), 0.1, **new),
        qU_mean=0.01 * torch.as_tensor(rng.standard_normal((Mc, Mr)), **new),
        qU_Ac=-torch.eye(Mc, **new), qU_Ar=-torch.eye(Mr, **new))


@dataclasses.dataclass(frozen=True)
class LVMOGP:
    kern_c: object = None       # the input (column) kernel
    kern_r: object = None       # the latent output-coordinate (row) kernel, RBF
    likelihood_variance: torch.Tensor = None
    Zc: torch.Tensor = None     # (Mc, Qc)
    Zr: torch.Tensor = None     # (Mr, Qr)
    q_Hmu: torch.Tensor = None  # (D, Qr)
    q_HS: torch.Tensor = None   # (D, Qr), positive
    qU_mean: torch.Tensor = None  # (Mc, Mr)
    qU_Ac: torch.Tensor = None  # free; LSc = _tril_chol(qU_Ac)
    qU_Ar: torch.Tensor = None  # free; LSr = _tril_chol(qU_Ar)
    X: torch.Tensor = None      # (N, Qc)
    Y: torch.Tensor = None      # (N, D)

    @classmethod
    def create(cls, X, Y, Xr_dim, kernel=None, kernel_row=None, num_inducing=(10, 5),
               noise_var=0.1, seed=0, dtype=None, device=None) -> "LVMOGP":
        """The output coordinates from the PCA of Y^T; Zc, Zr seeded subsets;
        ``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        X = np.atleast_2d(np.asarray(X, dtype=float))
        Y = np.asarray(Y, dtype=float)
        rng = np.random.default_rng(seed)
        H0 = pca_init(Y.T, Xr_dim)
        return cls(**_create_fields(kernel, kernel_row, X, H0, Y.shape[1], Xr_dim,
                                    num_inducing, noise_var, rng, new),
                   X=torch.as_tensor(X, **new), Y=torch.as_tensor(Y, **new))

    def elbo(self):
        """vardtc_svi_multiout.py:42-107 (uncertain rows, deterministic
        columns) minus KL(q(H) || N(0, I))."""
        N, D = self.Y.shape
        Mc, Mr = self.Zc.shape[0], self.Zr.shape[0]
        beta = 1.0 / (self.likelihood_variance + 1e-8)
        Lc, Lr, LSc, LSr = _factors(self)
        psi1_c = self.kern_c.K(self.X, self.Zc)
        psi0_c = torch.sum(self.kern_c.Kdiag(self.X))
        psi2_c = psi1_c.transpose(0, 1) @ psi1_c
        psi0_r, psi1_r, psi2_r = rbf_psi_stats(self.kern_r, self.Zr, self.q_Hmu, self.q_HS)

        Mt, LcInvLSc, LrInvLSr = _q_u(self, Lc, Lr, LSc, LSr)
        P2c, P2r = _whiten(Lc, psi2_c), _whiten(Lr, psi2_r)
        Sc_t = LcInvLSc @ LcInvLSc.transpose(0, 1)
        Sr_t = LrInvLSr @ LrInvLSr.transpose(0, 1)
        P1c = linalg.solve_lower(Lc, psi1_c.transpose(0, 1))
        P1r = linalg.solve_lower(Lr, psi1_r.transpose(0, 1))
        tr_Sr = torch.sum(torch.square(LrInvLSr))
        tr_Sc = torch.sum(torch.square(LcInvLSc))

        logL_A = (-torch.sum(torch.square(self.Y))
                  - torch.sum((Mt.transpose(0, 1) @ P2c @ Mt) * P2r)
                  - torch.sum(P2r * Sr_t) * torch.sum(P2c * Sc_t)
                  + 2.0 * torch.sum(self.Y * (P1c.transpose(0, 1) @ Mt @ P1r))
                  - psi0_c * psi0_r + torch.trace(P2r) * torch.trace(P2c))
        logL = (-N * D / 2.0 * (LOG_2_PI - torch.log(beta)) + beta / 2.0 * logL_A
                - Mc * (_sum_log_diag(Lr) - _sum_log_diag(LSr))
                - Mr * (_sum_log_diag(Lc) - _sum_log_diag(LSc))
                - torch.sum(torch.square(Mt)) / 2.0 - tr_Sr * tr_Sc / 2.0 + Mr * Mc / 2.0)
        return logL - gaussian_kl(self.q_Hmu, self.q_HS)

    def log_marginal_likelihood(self):
        return self.elbo()

    def predict(self, Xnew, include_likelihood=True):
        """(mu (N*, D), var (N*, D)) over every output at new inputs
        (vardtc_svi_multiout.py PosteriorMultioutput._raw_predict:237-266)."""
        Lc, Lr, LSc, LSr = _factors(self)
        Xnew = torch.atleast_2d(torch.as_tensor(Xnew, dtype=self.X.dtype, device=self.X.device))
        P1c = linalg.solve_lower(Lc, self.kern_c.K(Xnew, self.Zc).transpose(0, 1))
        psi0_c = self.kern_c.Kdiag(Xnew)
        _, psi1_r, psi2_r_n = rbf_psi_stats_n(self.kern_r, self.Zr, self.q_Hmu, self.q_HS)
        D = self.q_Hmu.shape[0]
        psi0_r = self.kern_r.variance.expand(D)
        P1r = linalg.solve_lower(Lr, psi1_r.transpose(0, 1))
        Mt, LcInvLSc, LrInvLSr = _q_u(self, Lc, Lr, LSc, LSr)
        Sc_t = LcInvLSc @ LcInvLSc.transpose(0, 1)
        Sr_t = LrInvLSr @ LrInvLSr.transpose(0, 1)

        mu = P1c.transpose(0, 1) @ (Mt @ P1r)
        P2rn = _whiten(Lr, psi2_r_n)                                   # (D, Mr, Mr)
        tr_P2rn = torch.diagonal(P2rn, dim1=1, dim2=2).sum(-1)
        tr_P2rn_Sr = torch.einsum("dij,ij->d", P2rn, Sr_t)
        outer = P1r.transpose(0, 1)[:, :, None] * P1r.transpose(0, 1)[:, None, :]
        tmp = torch.einsum("ij,djk,lk->dil", Mt, P2rn - outer, Mt)    # (D, Mc, Mc)
        var = (torch.einsum("dij,in,jn->nd", tmp, P1c, P1c)
               + psi0_c[:, None] * psi0_r[None, :]
               - tr_P2rn[None, :] * torch.sum(torch.square(P1c), dim=0)[:, None]
               + tr_P2rn_Sr[None, :] * torch.einsum("ij,in,jn->n", Sc_t, P1c, P1c)[:, None])
        if include_likelihood:
            var = var + self.likelihood_variance
        return mu, torch.clamp(var, min=1e-15)


@dataclasses.dataclass(frozen=True)
class LVMOGP_MD:
    """Missing-data LVMOGP (gp_multiout_regression_md.py,
    vardtc_svi_multiout_miss.py): observations are stacked (x_i, d_i, y_i),
    each output observed at its own inputs; the same bound evaluated
    pointwise. On a complete grid it equals ``LVMOGP.elbo``."""

    kern_c: object = None
    kern_r: object = None
    likelihood_variance: torch.Tensor = None
    Zc: torch.Tensor = None
    Zr: torch.Tensor = None
    q_Hmu: torch.Tensor = None
    q_HS: torch.Tensor = None
    qU_mean: torch.Tensor = None
    qU_Ac: torch.Tensor = None
    qU_Ar: torch.Tensor = None
    X: torch.Tensor = None        # (n_obs, Qc)
    out_idx: torch.Tensor = None  # (n_obs,) integer output index
    Y: torch.Tensor = None        # (n_obs,)

    @classmethod
    def create(cls, X, out_idx, Y, D, Xr_dim, kernel=None, kernel_row=None,
               num_inducing=(10, 5), noise_var=0.1, seed=0, dtype=None,
               device=None) -> "LVMOGP_MD":
        """Output coordinates from N(0, 0.25) draws; ``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        X = np.atleast_2d(np.asarray(X, dtype=float))
        rng = np.random.default_rng(seed)
        H0 = rng.standard_normal((D, Xr_dim)) * 0.5
        return cls(**_create_fields(kernel, kernel_row, X, H0, D, Xr_dim, num_inducing,
                                    noise_var, rng, new),
                   X=torch.as_tensor(X, **new),
                   out_idx=torch.as_tensor(np.asarray(out_idx, dtype=np.int64).reshape(-1),
                                           device=device),
                   Y=torch.as_tensor(np.asarray(Y, dtype=float).reshape(-1), **new))

    def elbo(self):
        Lc, Lr, LSc, LSr = _factors(self)
        beta = 1.0 / (self.likelihood_variance + 1e-8)
        n_obs = self.Y.shape[0]
        P1c = linalg.solve_lower(Lc, self.kern_c.K(self.X, self.Zc).transpose(0, 1))
        psi0_c = self.kern_c.Kdiag(self.X)
        D = self.q_Hmu.shape[0]
        _, psi1_r, psi2_r_n = rbf_psi_stats_n(self.kern_r, self.Zr, self.q_Hmu, self.q_HS)
        psi0_r = self.kern_r.variance.expand(D)
        P1r = linalg.solve_lower(Lr, psi1_r.transpose(0, 1))
        Mt, LcInvLSc, LrInvLSr = _q_u(self, Lc, Lr, LSc, LSr)
        Sc_t = LcInvLSc @ LcInvLSc.transpose(0, 1)
        Sr_t = LrInvLSr @ LrInvLSr.transpose(0, 1)
        P2rn = _whiten(Lr, psi2_r_n)
        d = self.out_idx
        Ef = torch.einsum("ci,cr,ri->i", P1c, Mt, P1r[:, d])
        # E[f^2]: the output index gathered first, v_i = Mt^T P1c[:, i]
        V = torch.einsum("cr,ci->ri", Mt, P1c)
        Ef2 = (torch.einsum("iru,ri,ui->i", P2rn[d], V, V)
               + torch.einsum("dru,ru->d", P2rn, Sr_t)[d]
               * torch.einsum("cs,ci,si->i", Sc_t, P1c, P1c))
        resid = (psi0_c * psi0_r[d] - torch.sum(torch.square(P1c), dim=0)
                 * torch.diagonal(P2rn, dim1=1, dim2=2).sum(-1)[d])
        data = (-0.5 * n_obs * (LOG_2_PI - torch.log(beta))
                - 0.5 * beta * torch.sum(torch.square(self.Y) - 2.0 * self.Y * Ef + Ef2 + resid))
        Mc, Mr = self.Zc.shape[0], self.Zr.shape[0]
        kl_u = 0.5 * (torch.sum(torch.square(LrInvLSr)) * torch.sum(torch.square(LcInvLSc))
                      + torch.sum(torch.square(Mt)) - Mc * Mr
                      + 2.0 * Mc * (_sum_log_diag(Lr) - _sum_log_diag(LSr))
                      + 2.0 * Mr * (_sum_log_diag(Lc) - _sum_log_diag(LSc)))
        return data - kl_u - gaussian_kl(self.q_Hmu, self.q_HS)

    def log_marginal_likelihood(self):
        return self.elbo()


def fit_lvmogp(model, maxiter=500):
    """L-BFGS over the kernels, the noise, Zc, Zr, q(H) and q(U), one lane."""
    packer = packer_for(model, overrides={"q_HS": POSITIVE}, fixed=("X", "Y", "out_idx"))
    return minimize_one(packer, model, maxiter)

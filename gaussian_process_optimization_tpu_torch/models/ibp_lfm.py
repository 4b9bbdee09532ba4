"""Indian-buffet-process latent force model (twin of
``gaussian_process_optimization_tpu/models/ibp_lfm.py``; GPy models/ibp_lfm.py:
VarDTC_minibatch_IBPLFM:19, IBPPrior:418, IBPPosterior:378, IBPLFM:467).

A second-order latent force model (``kernels/lfm.EQ_ODE2``) whose
output-to-force links d -> q are gated by Z_dq ~ Bernoulli(pi_q), pi_q ~
Beta(alpha / Q, 1). q(Z_dq) = Bernoulli(gamma_dq), q(pi_q) = Beta(tau_1q,
tau_2q). The collapsed VarDTC bound takes the spike-and-slab psi statistics of
the LFM kernel under q(Z) (gatherPsiStat, ibp_lfm.py:27-99):

    psi0 = sum_nq gamma[d_n, q] kdiag_q(x_n)
    psi1 = Kfu * gamma[d_n, q_m]
    psi2 = sum_d (Kfu_d^T Kfu_d) o Zp2_d[q_m, q_m'],
           Zp2_d = gamma_d gamma_d^T - diag(gamma_d^2) + diag(gamma_d)

plus E_q[log p(Z, pi)] + H[q] (ibp_lfm.py:426-450; the reference adds this
"KL_divergence", which is -KL). EQ_ODE2's K goes through the port's own
Faddeeva function (``ops/special.wofz``), complex64 in float32.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.lfm import EQ_ODE2
from ..ops import linalg
from .gp import LOG_2_PI
from .lvmogp import _eye
from .parameters import make_packer


def ibp_neg_kl(gamma, tau, alpha):
    """E_q[log p(Z, pi)] + H[q(Z)] + H[q(pi)] (IBPPrior.KL_divergence,
    ibp_lfm.py:426-450: the signed term the bound adds)."""
    D, Q = gamma.shape
    ad = alpha / Q
    t1, t2 = tau[0], tau[1]
    sum_eta = torch.sum(gamma, dim=0)
    psitau1, psitau2 = torch.special.digamma(t1), torch.special.digamma(t2)
    psitau = torch.special.digamma(t1 + t2)
    part1 = (torch.sum(sum_eta * psitau1 + (D - sum_eta) * psitau2 - D * psitau)
             + (ad - 1.0) * torch.sum(psitau1 - psitau) + Q * math.log(ad))
    g = torch.clamp(gamma, 1e-9, 1 - 1e-9)
    part2 = (torch.sum(-(1 - g) * torch.log1p(-g) - g * torch.log(g))
             + torch.sum(torch.lgamma(t1) + torch.lgamma(t2) - torch.lgamma(t1 + t2)
                         - (t1 - 1.0) * psitau1 - (t2 - 1.0) * psitau2
                         + (t1 + t2 - 2.0) * psitau))
    return part1 + part2


@dataclasses.dataclass(frozen=True)
class IBPLFM:
    """X (N, 2): stacked (time, output index < D); Y (N, 1). Z (M, 2): inducing
    (time, force index D + q), by default evenly spaced times for every force.
    gamma_logit (D, Q) unconstrained, gamma its sigmoid; tau (2, Q) positive."""

    kern: EQ_ODE2 = None
    gamma_logit: torch.Tensor = None
    tau: torch.Tensor = None
    Z: torch.Tensor = None
    likelihood_variance: torch.Tensor = None
    X: torch.Tensor = None
    Y: torch.Tensor = None
    alpha: float = 2.0

    @classmethod
    def create(cls, X, Y, output_dim, rank, kernel=None, Gamma=None, tau=None, num_inducing=10,
               Z=None, noise_var=0.1, alpha=2.0, seed=0, dtype=None, device=None) -> "IBPLFM":
        """``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        rng = np.random.default_rng(seed)
        X = np.atleast_2d(np.asarray(X, dtype=float))
        Y = np.asarray(Y, dtype=float).reshape(X.shape[0], 1)
        if kernel is None:
            kernel = EQ_ODE2.create(output_dim=output_dim, rank=rank, seed=seed, **new)
        g = (0.5 + 0.1 * rng.standard_normal((output_dim, rank)) if Gamma is None
             else np.asarray(Gamma, dtype=float))  # ibp_lfm.py:487-491
        g = np.clip(g, 1e-6, 1 - 1e-6)
        if Z is None:
            times = np.linspace(X[:, 0].min(), X[:, 0].max(), max(1, num_inducing // rank))
            Z = np.vstack([np.stack([times, np.full(times.shape[0], float(output_dim + q))], 1)
                           for q in range(rank)])
        return cls(kern=kernel, gamma_logit=torch.as_tensor(np.log(g) - np.log1p(-g), **new),
                   tau=torch.as_tensor(np.ones((2, rank)) if tau is None else tau, **new),
                   Z=torch.as_tensor(np.asarray(Z, dtype=float), **new),
                   likelihood_variance=torch.tensor(float(noise_var), **new),
                   X=torch.as_tensor(X, **new), Y=torch.as_tensor(Y, **new), alpha=float(alpha))

    @property
    def gamma(self):
        return torch.sigmoid(self.gamma_logit)

    def _indices(self, X):
        D = self.gamma.shape[0]
        return (torch.round(X[:, -1]).to(torch.int64),
                torch.round(self.Z[:, -1]).to(torch.int64) - D)

    def _psi_stats(self):
        """The spike-and-slab psi statistics, without the beta scaling."""
        gamma = self.gamma
        D, Q = gamma.shape
        indX, indZ = self._indices(self.X)
        psi1_raw = self.kern.K(self.X, self.Z)
        gX = gamma[indX]
        psi1 = psi1_raw * gX[:, indZ]
        psi0 = torch.sum(self.kern.Kdiag_per_force(self.X) * gX)
        onehot = torch.nn.functional.one_hot(indX, D).to(psi1_raw.dtype)
        B_d = torch.einsum("nd,nm,nk->dmk", onehot, psi1_raw, psi1_raw)
        eye = _eye(Q, gamma)[None]
        Zp2 = (gamma[:, :, None] * gamma[:, None, :] - eye * torch.square(gamma)[:, :, None]
               + eye * gamma[:, :, None])
        psi2 = torch.sum(B_d * Zp2[:, indZ][:, :, indZ], dim=0)
        return psi0, psi1, psi2

    def _factors(self, psi2, beta):
        m = self.Z.shape[0]
        Kmm = self.kern.K(self.Z)
        Kmm = Kmm + 1e-6 * torch.mean(torch.diagonal(Kmm)) * _eye(m, Kmm)
        Lm, _, _ = linalg.jitchol(Kmm)
        P2 = linalg.backsub_both_sides(Lm, psi2 * beta, "right")
        LL, _, _ = linalg.jitchol(_eye(m, P2) + P2)
        return Lm, P2, LL

    def data_bound(self):
        """The collapsed VarDTC bound with the spike-and-slab psi statistics
        (inference_likelihood, ibp_lfm.py:101-165), one output column."""
        beta = 1.0 / torch.clamp(self.likelihood_variance, min=1e-6)
        n = self.X.shape[0]
        psi0, psi1, psi2 = self._psi_stats()
        Lm, P2, LL = self._factors(psi2, beta)
        psi1Y = (self.Y.transpose(0, 1) @ psi1) * beta
        b = linalg.solve_lower(LL, linalg.solve_lower(Lm, psi1Y.transpose(0, 1)))
        return (-0.5 * (n * LOG_2_PI - n * torch.log(beta) + psi0 * beta - torch.trace(P2)
                        + torch.sum(torch.square(self.Y)) * beta - torch.sum(torch.square(b)))
                - 0.5 * linalg.logdet_from_chol(LL))

    def elbo(self):
        return self.data_bound() + ibp_neg_kl(self.gamma, self.tau, self.alpha)

    def log_likelihood(self):
        return self.elbo()

    def log_marginal_likelihood(self):
        return self.elbo()

    def predict(self, Xnew, include_likelihood=True):
        """Mean and variance at stacked (time, output index) rows from the
        bound's optimal q(u)."""
        gamma = self.gamma
        beta = 1.0 / torch.clamp(self.likelihood_variance, min=1e-6)
        _, psi1, psi2 = self._psi_stats()
        Lm, _, LL = self._factors(psi2, beta)
        b = linalg.solve_lower(LL, linalg.solve_lower(
            Lm, ((self.Y.transpose(0, 1) @ psi1) * beta).transpose(0, 1)))
        Xnew = torch.atleast_2d(torch.as_tensor(Xnew, dtype=self.X.dtype, device=self.X.device))
        indXs, indZ = self._indices(Xnew)
        Ks = self.kern.K(Xnew, self.Z) * gamma[indXs][:, indZ]
        tmp = linalg.solve_lower(Lm, Ks.transpose(0, 1))
        tmp2 = linalg.solve_lower(LL, tmp)
        mu = tmp2.transpose(0, 1) @ b
        kdiag = torch.sum(self.kern.Kdiag_per_force(Xnew) * gamma[indXs], dim=1)
        var = kdiag - torch.sum(torch.square(tmp), 0) + torch.sum(torch.square(tmp2), 0)
        if include_likelihood:
            var = var + self.likelihood_variance
        return mu, torch.clamp(var, min=1e-15)[:, None]

    def optimize(self, maxiter=200, learning_rate=0.02, fix_kernel=False):
        """Adam on -ELBO over gamma, tau, the kernel, Z and the noise (the
        reference's optax loop, torch's Adam set to its update);
        ``(fitted, elbo trace)``."""
        fix = ("X", "Y") + (("W", "lengthscale", "C", "B") if fix_kernel else ())
        packer = make_packer(self, fix=fix)
        u = packer.pack(self).detach().clone().requires_grad_(True)
        opt = torch.optim.Adam([u], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        trace = []
        for _ in range(maxiter):
            opt.zero_grad(set_to_none=True)
            loss = -packer.unpack(u, reference=self).elbo()
            loss.backward()
            opt.step()
            trace.append(-float(loss.detach()))
        with torch.no_grad():
            return packer.unpack(u.detach(), reference=self), trace

"""Spike-and-slab GPLVM (twin of ``gaussian_process_optimization_tpu/models/ss_gplvm.py``;
GPy models/ss_gplvm.py, ss_mrd.py, kern/src/psi_comp/ssrbf_psi_comp.py).

A Bayesian GPLVM whose q(x_nq) = gamma_nq N(mu_nq, S_nq) + (1 - gamma_nq)
delta(x_nq) selects the relevant latent dimensions. The SSRBF psi statistics
are two-term log-sum-exps per factor (the reference's C triple loop,
vectorized over (n, m, q) and (n, m, m', q)); the KL is the spike-and-slab
prior's (variational.py SpikeAndSlabPrior.KL_divergence, prior variance 1);
the bound is the Bayesian GPLVM's. At gamma -> 1 it is the Bayesian GPLVM.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.transforms import POSITIVE, Logistic
from .gplvm import BayesianGPLVM, collapsed_bound_from_psi, minimize_one, packer_for
from .mrd import MRD


def ssrbf_psi_stats(kern, Z, mu, S, gamma):
    """(psi0, psi1, psi2) of the RBF kernel under the spike-and-slab posterior
    (ssrbf_psi_comp.py:49-88, in log-sum-exp form)."""
    var = kern.variance
    Q = mu.shape[1]
    l2 = torch.square(kern.lengthscale).expand(Q)
    log_g = torch.log(torch.clamp(gamma, 1e-12, 1.0))
    log_g1 = torch.log(torch.clamp(1.0 - gamma, 1e-12, 1.0))
    psi0 = mu.shape[0] * var

    denom1 = S + l2[None, :]
    log_denom1 = torch.log1p(S / l2[None, :])
    muZ = mu[:, None, :] - Z[None, :, :]
    a1 = log_g[:, None, :] - 0.5 * (torch.square(muZ) / denom1[:, None, :]
                                    + log_denom1[:, None, :])
    a2 = log_g1[:, None, :] - torch.square(Z)[None, :, :] / (2.0 * l2)
    psi1 = var * torch.exp(torch.sum(torch.logaddexp(a1, a2), dim=2))

    denom2 = 2.0 * S + l2[None, :]
    log_denom2 = torch.log1p(2.0 * S / l2[None, :])
    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    dZ2 = torch.square(Z[:, None, :] - Z[None, :, :])
    Z2sum = torch.square(Z)[:, None, :] + torch.square(Z)[None, :, :]
    muZhat = mu[:, None, None, :] - Zbar[None, :, :, :]
    b1 = (log_g[:, None, None, :] - dZ2[None] / (4.0 * l2)
          - torch.square(muZhat) / denom2[:, None, None, :]
          - 0.5 * log_denom2[:, None, None, :])
    b2 = log_g1[:, None, None, :] - Z2sum[None] / (2.0 * l2)
    psi2n = torch.square(var) * torch.exp(torch.sum(torch.logaddexp(b1, b2), dim=3))
    return psi0, psi1, torch.sum(psi2n, dim=0)


def spike_slab_kl(mu, S, gamma, pi):
    """KL of the spike-and-slab posterior from its prior (variational.py:52-68)."""
    g = torch.clamp(gamma, 1e-12, 1.0 - 1e-12)
    pi = torch.clamp(torch.as_tensor(pi, dtype=mu.dtype, device=mu.device), 1e-12, 1.0 - 1e-12)
    kl_bern = torch.sum(g * torch.log(g / pi) + (1 - g) * torch.log((1 - g) / (1 - pi)))
    kl_gauss = 0.5 * torch.sum(g * (torch.square(mu) + S - torch.log(S) - 1.0))
    return kl_bern + kl_gauss


@dataclasses.dataclass(frozen=True)
class SSGPLVM:
    """Spike-and-slab GPLVM (ss_gplvm.py SSGPLVM)."""

    kern: object = None
    likelihood_variance: torch.Tensor = None
    Z: torch.Tensor = None
    q_mu: torch.Tensor = None     # (N, Q)
    q_S: torch.Tensor = None      # (N, Q), positive
    q_gamma: torch.Tensor = None  # (N, Q) in (0, 1)
    Y: torch.Tensor = None
    pi: float = 0.5               # the slab's prior inclusion probability

    @classmethod
    def create(cls, Y, input_dim, num_inducing=10, kernel=None, noise_var=0.1, pi=0.5, seed=0,
               dtype=None, device=None) -> "SSGPLVM":
        """The Bayesian GPLVM's start with gamma = 0.5; ``device`` None means
        the card."""
        base = BayesianGPLVM.create(Y, input_dim, num_inducing=num_inducing, kernel=kernel,
                                    noise_var=noise_var, seed=seed, dtype=dtype, device=device)
        return cls(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
                   q_gamma=torch.full_like(base.q_S, 0.5), pi=float(pi))

    def elbo(self):
        psi = ssrbf_psi_stats(self.kern, self.Z, self.q_mu, self.q_S, self.q_gamma)
        bound = collapsed_bound_from_psi(self.kern, self.Z, self.likelihood_variance, self.Y,
                                         *psi)
        return bound - spike_slab_kl(self.q_mu, self.q_S, self.q_gamma, self.pi)

    def log_marginal_likelihood(self):
        return self.elbo()

    def relevance(self):
        """Each latent dimension's mean inclusion probability."""
        return torch.mean(self.q_gamma, dim=0)


@dataclasses.dataclass(frozen=True)
class SSMRD:
    """Spike-and-slab MRD (ss_mrd.py): V views share one spike-and-slab latent;
    sum_v collapsed_bound_v(SSRBF psi statistics) - the spike-and-slab KL."""

    kerns: tuple = ()
    noise_vars: torch.Tensor = None
    Zs: tuple = ()
    q_mu: torch.Tensor = None
    q_S: torch.Tensor = None
    q_gamma: torch.Tensor = None
    Ys: tuple = ()
    pi: float = 0.5

    @classmethod
    def create(cls, Ys, input_dim, num_inducing=10, noise_var=0.1, pi=0.5, seed=0, dtype=None,
               device=None) -> "SSMRD":
        base = MRD.create(Ys, input_dim, num_inducing=num_inducing, noise_var=noise_var,
                          seed=seed, dtype=dtype, device=device)
        return cls(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
                   q_gamma=torch.full_like(base.q_S, 0.5), pi=float(pi))

    def elbo(self):
        bound = 0.0
        for v, (k, Z, Y) in enumerate(zip(self.kerns, self.Zs, self.Ys)):
            psi = ssrbf_psi_stats(k, Z, self.q_mu, self.q_S, self.q_gamma)
            bound = bound + collapsed_bound_from_psi(k, Z, self.noise_vars[v], Y, *psi)
        return bound - spike_slab_kl(self.q_mu, self.q_S, self.q_gamma, self.pi)

    def log_marginal_likelihood(self):
        return self.elbo()


def fit_ssgplvm(model: SSGPLVM, maxiter=300):
    """L-BFGS over the hyperparameters, Z and q's (mu, S, gamma), one lane;
    gamma through a logistic onto (1e-6, 1 - 1e-6)."""
    packer = packer_for(model, overrides={"q_gamma": Logistic(lo=1e-6, hi=1.0 - 1e-6),
                                          "q_S": POSITIVE}, fixed=("Y",))
    return minimize_one(packer, model, maxiter)

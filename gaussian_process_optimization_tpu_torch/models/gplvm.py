"""The GPLVM family (twin of ``gaussian_process_optimization_tpu/models/gplvm.py``;
GPy models/gplvm.py, bayesian_gplvm.py, kern/src/psi_comp/rbf_psi_comp.py).

- The point GPLVM is the exact GP with its input leaf ``X`` trained beside the
  hyperparameters. ``K(X, X)`` passes one tensor as both inputs of the K build
  (``ops/cuda_kernels.stationary_K``), so autograd sums the K backward's row
  pass (dX) and its column pass (dZ): the X-gradient of the reference's two
  ``_pallas_K_bwd`` calls over the symmetrized G.
- The Bayesian GPLVM: q(X) = N(mu, diag(S)), the RBF kernel's closed-form psi
  statistics, and the uncertain-input collapsed bound (Titsias & Lawrence 2010)
  minus KL(q(X) || N(0, I)).

The latent models here and in ``mrd.py``, ``ss_gplvm.py``, ``lvmogp.py``,
``bgplvm_svi.py`` and ``ibp_lfm.py`` carry no lane axis: each is fitted as one
L-BFGS lane (:func:`minimize_one`), as the reference fits them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..ops import lbfgs, linalg
from ..utils.packing import Packer
from ..utils.transforms import IDENTITY, POSITIVE
from .fit import make_objective
from .gp import LOG_2_PI, GPRegression
from .parameters import DATA_NAMES, POSITIVE_NAMES, leaf_names


def pca_init(Y: np.ndarray, input_dim: int) -> np.ndarray:
    """The first ``input_dim`` principal scores of centred Y, each scaled to
    unit standard deviation (the reference's PCA initialization)."""
    Yc = Y - Y.mean(0)
    _, _, Vt = np.linalg.svd(Yc, full_matrices=False)
    X0 = Yc @ Vt[:input_dim].T
    return X0 / (X0.std(0) + 1e-9)


def packer_for(model, overrides=None, fixed=()) -> Packer:
    """A packer with the reference's per-model rule: a leaf named in
    ``POSITIVE_NAMES`` through softplus, one named in ``overrides`` through
    its transform there, the rest identity; the leaves named in ``fixed``
    frozen."""
    names = leaf_names(model)
    overrides = overrides or {}
    return Packer(model,
                  transforms=[overrides.get(n, POSITIVE if n in POSITIVE_NAMES else IDENTITY)
                              for n in names],
                  fixed=[n in fixed for n in names])


def minimize_one(packer: Packer, model, maxiter: int, priors=None, objective=None):
    """One L-BFGS lane from the model's own parameters, on ``objective(u)`` of
    the packed vector, by default -(LML + log prior) (``fit.make_objective``);
    ``(fitted, LBFGSResult)``."""
    if objective is None:
        obj = make_objective(packer, priors=priors)

        def objective(u):
            return obj(u, model)

    res = lbfgs.minimize(lambda U: objective(U[0]).reshape(1), packer.pack(model).detach(),
                         maxiter=maxiter)
    with torch.no_grad():
        return packer.unpack(res.x, reference=model), res


# --------------------------------------------------------------------- GPLVM
def make_gplvm(Y, input_dim, kernel=None, init="pca", seed=0, dtype=None,
               device=None) -> GPRegression:
    """Point-estimate GPLVM: a GPRegression whose X starts at Y's principal
    scores, or at N(0, 1) draws with ``init="random"`` (gplvm.py). ``device``
    None means the card."""
    Y = np.asarray(Y, dtype=float)
    if init == "pca":
        X0 = pca_init(Y, input_dim)
    else:
        X0 = np.random.default_rng(seed).standard_normal((Y.shape[0], input_dim))
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    kernel = kernel or RBF.create(input_dim, ARD=True, dtype=dtype, device=device)
    return GPRegression.create(X0, Y, kernel=kernel, noise_var=0.1, dtype=dtype, device=device)


def gplvm_packer(model) -> Packer:
    """Every data leaf but X frozen: X trains with the hyperparameters."""
    return packer_for(model, fixed=DATA_NAMES - {"X"})


def fit_gplvm(model, maxiter=500, generator=None, priors=None):
    """L-BFGS over the hyperparameters and the latent X, one lane from the
    model's own X. ``priors``: field name -> Prior (``models/fit.make_objective``);
    ``{"X": DGPLVMPrior(lbl=...)}`` gives the discriminative GPLVM (GPy
    priors.py:535). ``generator`` is unused, as the reference's ``key`` is: the
    lane draws nothing."""
    return minimize_one(gplvm_packer(model), model, maxiter, priors=priors)


# ------------------------------------------------------- RBF psi statistics
def rbf_psi_stats_n(kern, Z, mu, S):
    """(psi0, psi1, psi2n) of an RBF kernel under q(x_n) = N(mu_n, diag(S_n)),
    psi2 per point, ``(N, M, M)`` (GPy kern.psi2n):
      psi0 = sum_n <k(x_n, x_n)> = N variance
      psi1[n, m] = <k(x_n, z_m)>
      psi2n[n, m, m'] = <k(x_n, z_m) k(x_n, z_m')>
    ARD lengthscales are supported."""
    var = kern.variance
    D = mu.shape[1]
    ls2 = torch.square(kern.lengthscale).expand(D)
    psi0 = mu.shape[0] * var

    denom1 = S + ls2[None, :]
    dist1 = torch.square(mu[:, None, :] - Z[None, :, :]) / denom1[:, None, :]
    logdet1 = torch.sum(torch.log1p(S / ls2[None, :]), dim=1)
    psi1 = var * torch.exp(-0.5 * torch.sum(dist1, dim=2) - 0.5 * logdet1[:, None])

    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    dZ2 = torch.square(Z[:, None, :] - Z[None, :, :])
    denom2 = 2.0 * S + ls2[None, :]
    logdet2 = torch.sum(torch.log1p(2.0 * S / ls2[None, :]), dim=1)
    cross = torch.exp(-0.25 * torch.sum(dZ2 / ls2, dim=2))  # independent of n
    diff = mu[:, None, None, :] - Zbar[None, :, :, :]
    quad = torch.sum(torch.square(diff) / denom2[:, None, None, :], dim=3)
    psi2n = torch.square(var) * cross[None, :, :] * torch.exp(
        -quad - 0.5 * logdet2[:, None, None])
    return psi0, psi1, psi2n


def rbf_psi_stats(kern, Z, mu, S):
    """(psi0, psi1, psi2) with psi2 summed over the points, ``(M, M)``."""
    psi0, psi1, psi2n = rbf_psi_stats_n(kern, Z, mu, S)
    return psi0, psi1, torch.sum(psi2n, dim=0)


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


# ------------------------------------------------------- Bayesian GPLVM bound
@dataclasses.dataclass(frozen=True)
class BayesianGPLVM:
    """Variational GPLVM: q(X) = N(q_mu, diag(q_S)), an RBF kernel, inducing
    inputs Z (bayesian_gplvm.py with the var_dtc psi-statistics path)."""

    kern: object = None
    likelihood_variance: torch.Tensor = None
    Z: torch.Tensor = None
    q_mu: torch.Tensor = None  # (N, Q)
    q_S: torch.Tensor = None   # (N, Q), positive
    Y: torch.Tensor = None     # (N, P), centred

    @classmethod
    def create(cls, Y, input_dim, num_inducing=10, kernel=None, noise_var=0.1, seed=0,
               dtype=None, device=None) -> "BayesianGPLVM":
        """PCA means, S = 0.5, Z a seeded subset of the means; ``device`` None
        means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        Y = np.asarray(Y, dtype=float)
        n = Y.shape[0]
        mu0 = pca_init(Y, input_dim)
        Z0 = mu0[np.random.default_rng(seed).permutation(n)[:num_inducing]].copy()
        return cls(kern=kernel or RBF.create(input_dim, ARD=True, **new),
                   likelihood_variance=torch.tensor(float(noise_var), **new),
                   Z=torch.as_tensor(Z0, **new), q_mu=torch.as_tensor(mu0, **new),
                   q_S=torch.full((n, input_dim), 0.5, **new),
                   Y=torch.as_tensor(Y - Y.mean(0), **new))

    def elbo(self):
        """The uncertain-input collapsed bound (GPy var_dtc with psi
        statistics) minus KL(q(X) || N(0, I))."""
        bound = uncertain_input_bound(self.kern, self.Z, self.likelihood_variance, self.Y,
                                      self.q_mu, self.q_S)
        return bound - gaussian_kl(self.q_mu, self.q_S)

    def log_marginal_likelihood(self):
        return self.elbo()

    def posterior_u(self):
        """(wv, Wi), the bound's q(u) in Woodbury form (GPy var_dtc.py:199-212):
        wv = beta Lm^-T B^-1 Lm^-1 psi1^T Y, Wi = Lm^-T (I - B^-1) Lm^-1.
        Shared by :meth:`predict` and ``infer_newX``."""
        sigma2 = torch.clamp(self.likelihood_variance, min=1e-6)
        m = self.Z.shape[0]
        _, psi1, psi2 = rbf_psi_stats(self.kern, self.Z, self.q_mu, self.q_S)
        Lm, _, _ = linalg.jitchol(self.kern.K(self.Z) + 1e-6 * _eye(m, psi2))
        A = scaled_psi2(Lm, psi2, sigma2)
        LB, _, _ = linalg.jitchol(_eye(m, A) + A)
        wv = linalg.solve_lower_t(
            Lm, linalg.cho_solve(LB, linalg.solve_lower(Lm, psi1.transpose(0, 1) @ self.Y))
        ) / sigma2
        Wi = linalg.backsub_both_sides(Lm, _eye(m, A) - linalg.dpotri(LB))
        return wv, Wi

    def predict(self, Xnew, full_cov=False, include_likelihood=True, posterior=None):
        """Decode latent points to data space through the bound's q(u) (GPy
        SparseGP.predict, sparse_gp.py:14). ``posterior``: a cached
        :meth:`posterior_u`."""
        Xnew = torch.atleast_2d(torch.as_tensor(Xnew, dtype=self.Z.dtype, device=self.Z.device))
        wv, Wi = self.posterior_u() if posterior is None else posterior
        Ks = self.kern.K(Xnew, self.Z)
        mu = Ks @ wv
        if full_cov:
            var = self.kern.K(Xnew) - Ks @ Wi @ Ks.transpose(0, 1)
            if include_likelihood:
                var = var + self.likelihood_variance * _eye(Xnew.shape[0], var)
        else:
            var = self.kern.Kdiag(Xnew) - torch.sum(Ks * (Ks @ Wi), dim=1)
            var = torch.clamp(var, min=1e-12)[:, None]
            if include_likelihood:
                var = var + self.likelihood_variance
        return mu, var


def uncertain_input_bound(kern, Z, noise_var, Y, q_mu, q_S):
    """The collapsed bound of one view under q(X) = N(q_mu, diag(q_S)) (GPy
    var_dtc.py, uncertain inputs; shared by BayesianGPLVM and MRD)."""
    psi0, psi1, psi2 = rbf_psi_stats(kern, Z, q_mu, q_S)
    return collapsed_bound_from_psi(kern, Z, noise_var, Y, psi0, psi1, psi2)


def collapsed_bound_from_psi(kern, Z, noise_var, Y, psi0, psi1, psi2):
    """The collapsed uncertain-input bound from given psi statistics (shared
    with the spike-and-slab GPLVM's SSRBF statistics)."""
    sigma2 = noise_var + config.noise_jitter
    n, p = Y.shape
    m = Z.shape[0]
    Lm, _, _ = linalg.jitchol(kern.K(Z) + 1e-6 * _eye(m, psi2))
    A = scaled_psi2(Lm, psi2, sigma2)
    LB, _, _ = linalg.jitchol(_eye(m, A) + A)
    c = linalg.solve_lower(LB, linalg.solve_lower(Lm, psi1.transpose(0, 1) @ Y)) / sigma2
    return (-0.5 * n * p * (LOG_2_PI + torch.log(sigma2))
            - 0.5 * p * linalg.logdet_from_chol(LB)
            - 0.5 * torch.sum(torch.square(Y)) / sigma2
            + 0.5 * torch.sum(torch.square(c))
            - 0.5 * p / sigma2 * (psi0 - torch.trace(A) * sigma2))


def scaled_psi2(Lm, psi2, sigma2):
    """A = Lm^-1 psi2 Lm^-T / sigma2, the Gram that B = I + A adds to the
    identity. Float64 takes the reference's two triangular solves. In float32
    at an ill-conditioned Kmm those solves cancel: at the Bayesian GPLVM's
    fitted point (cond(Kmm) ~ 2e5) the symmetric part of their A has
    eigenvalues near -70 where float64's least is 0.27, below every rung of
    the jitter ladder, and the bound is NaN. There A is formed as W W^T with
    W = Lm^-1 chol(psi2), positive semidefinite by construction, so B always
    factors."""
    if psi2.dtype == torch.float32:
        Lp, _, _ = linalg.jitchol(psi2)
        return linalg.tdot(linalg.solve_lower(Lm, Lp)) / sigma2
    return linalg.backsub_both_sides(Lm, psi2, "right") / sigma2


def gaussian_kl(q_mu, q_S):
    """KL(N(q_mu, diag(q_S)) || N(0, I))."""
    return 0.5 * torch.sum(torch.square(q_mu) + q_S - torch.log(q_S) - 1.0)

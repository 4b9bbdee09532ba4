"""Classification models (twin of
``gaussian_process_optimization_tpu/models/classification.py``; GPy
models/gp_classification.py:10, sparse_gp_classification.py:12 and :103).

- ``GPClassification``: RBF, probit Bernoulli and dense EP.
- ``SparseGPClassification``: inducing points and EPDTC.
- ``SparseGPClassificationUncertainInput``: EPDTC on the RBF psi statistics of
  Gaussian input uncertainty.

``predict`` gives class probabilities through the closed-form probit marginal.
``optimize`` maximizes the EP evidence in the alternated way (EPBase
ep_mode='alternated', expectation_propagation.py:188): run EP to convergence,
then L-BFGS on the evidence at the fixed sites over the hyperparameters (and Z
for the sparse models), repeat. At the EP fixed point the site-fixed gradient
is the total derivative. The kernel matrices come from the kernel's own ``K``,
so a stationary kernel at a shape that passes the CUDA kernels' gate launches
the K build and its backward.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..ops import lbfgs
from .ep import (_dense_ep_lml, _dense_posterior_from_sites, ep_inference, ep_predict,
                 epdtc_inference, epdtc_predict)
from .gplvm import rbf_psi_stats_n
from .laplace import as_inputs
from .likelihoods import Bernoulli
from .parameters import make_packer


def _probit(mu, var):
    return 0.5 * torch.special.erfc(-(mu / torch.sqrt(1.0 + var)) / math.sqrt(2.0))


def _data(X, Y, kernel, dtype, device):
    """(X, labels in {-1, +1}, kernel) on the device."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    X = torch.as_tensor(np.atleast_2d(np.asarray(X, dtype=float)), dtype=dtype, device=device)
    Y = np.where(np.asarray(Y, dtype=float).reshape(-1) > 0, 1.0, -1.0)
    kernel = kernel or RBF.create(X.shape[1], dtype=dtype, device=device)
    return X, torch.as_tensor(Y, dtype=dtype, device=device), kernel


def _inducing(X, Z, num_inducing, seed):
    if Z is None:
        idx = np.random.default_rng(seed).permutation(X.shape[0])[:num_inducing]
        return X[torch.as_tensor(idx, device=X.device)].clone()
    return as_inputs(Z, X)


def alternated_optimize(model, rounds, maxiter, site_fixed_lml, fix=()):
    """``rounds`` of: EP to convergence, then ``maxiter`` L-BFGS steps on
    -``site_fixed_lml(m, tau, nu)`` over the free leaves, sites held fixed.
    Returns ``(model, LBFGSResult of the last round)``."""
    res = None
    for _ in range(rounds):
        post = model.inference()
        tau, nu = post.tau_site.detach(), post.nu_site.detach()
        packer = make_packer(model, fix=fix)

        def obj(U, model=model, packer=packer, tau=tau, nu=nu):
            m = packer.unpack(U[0], reference=model)
            return -site_fixed_lml(m, tau, nu).reshape(1)

        res = lbfgs.minimize(obj, packer.pack(model).detach(), maxiter=maxiter)
        model = packer.unpack(res.x, reference=model)
    return model, res


@dataclasses.dataclass(frozen=True)
class GPClassification:
    """Dense EP probit classification (gp_classification.py:10)."""

    kern: object = None
    X: torch.Tensor = None
    Y: torch.Tensor = None  # (N,) in {-1, +1}; 0/1 accepted by create
    inference_mode: str = "parallel"
    max_sweeps: int = 60

    @classmethod
    def create(cls, X, Y, kernel=None, inference_mode="parallel", max_sweeps=60, dtype=None,
               device=None) -> "GPClassification":
        """``device`` None means the card."""
        X, Y, kernel = _data(X, Y, kernel, dtype, device)
        return cls(kern=kernel, X=X, Y=Y, inference_mode=inference_mode, max_sweeps=max_sweeps)

    def inference(self):
        with torch.no_grad():
            K = self.kern.K(self.X)
        return ep_inference(K, self.Y, Bernoulli(), mode=self.inference_mode,
                            max_sweeps=self.max_sweeps)

    def log_marginal_likelihood(self):
        return self.inference().lml

    def site_fixed_lml(self, tau, nu):
        """The EP evidence at fixed sites, differentiable in the kernel."""
        K = self.kern.K(self.X)
        mu, sigma2, L, _ = _dense_posterior_from_sites(K, tau, nu)
        return _dense_ep_lml(Bernoulli(), self.Y, tau, nu, mu, sigma2, L, 1.0)

    def predict_latent(self, Xnew, posterior=None):
        post = posterior if posterior is not None else self.inference()
        Xnew = as_inputs(Xnew, self.X)
        return ep_predict(self.kern.K(self.X), self.kern.K(self.X, Xnew), self.kern.Kdiag(Xnew),
                          post)

    def predict(self, Xnew, posterior=None):
        """p(y = 1 | x) by the probit predictive (GPML 3.25)."""
        return _probit(*self.predict_latent(Xnew, posterior=posterior))

    def optimize(self, rounds=3, maxiter=30):
        return alternated_optimize(self, rounds, maxiter, GPClassification.site_fixed_lml)


class _SparseEP:
    """What the two EPDTC classifiers share; ``_stats`` gives (Kmm, Kmn,
    Kdiag, psi2n)."""

    _fix = ()

    def _epdtc(self, sites=None):
        Kmm, Kmn, Kdiag, psi2n = self._stats()
        return epdtc_inference(Kmm, Kmn, Kdiag, self.Y, Bernoulli(), mode=self.inference_mode,
                               max_sweeps=self.max_sweeps, psi2n=psi2n, sites=sites)

    def inference(self):
        with torch.no_grad():
            return self._epdtc()

    def log_marginal_likelihood(self):
        return self.inference().lml

    def site_fixed_lml(self, tau, nu):
        return self._epdtc(sites=(tau, nu)).lml

    def optimize(self, rounds=3, maxiter=30):
        """Alternated EP evidence maximization over the hyperparameters and Z."""
        return alternated_optimize(self, rounds, maxiter, type(self).site_fixed_lml,
                                   fix=self._fix)

    def predict_latent(self, Xnew, posterior=None):
        post = posterior if posterior is not None else self.inference()
        Xnew = as_inputs(Xnew, self.X)
        return epdtc_predict(post.Lm, post.LB, post.c, self.kern.K(self.Z, Xnew),
                             self.kern.Kdiag(Xnew))

    def predict(self, Xnew, posterior=None):
        return _probit(*self.predict_latent(Xnew, posterior=posterior))


@dataclasses.dataclass(frozen=True)
class SparseGPClassification(_SparseEP):
    """EPDTC probit classification on inducing points
    (sparse_gp_classification.py:12)."""

    kern: object = None
    Z: torch.Tensor = None
    X: torch.Tensor = None
    Y: torch.Tensor = None
    inference_mode: str = "parallel"
    max_sweeps: int = 60

    @classmethod
    def create(cls, X, Y, kernel=None, num_inducing=10, Z=None, inference_mode="parallel",
               max_sweeps=60, seed=0, dtype=None, device=None) -> "SparseGPClassification":
        """Z a seeded random subset of X unless given; ``device`` None means the card."""
        X, Y, kernel = _data(X, Y, kernel, dtype, device)
        return cls(kern=kernel, Z=_inducing(X, Z, num_inducing, seed), X=X, Y=Y,
                   inference_mode=inference_mode, max_sweeps=max_sweeps)

    def _stats(self):
        return self.kern.K(self.Z), self.kern.K(self.Z, self.X), self.kern.Kdiag(self.X), None


@dataclasses.dataclass(frozen=True)
class SparseGPClassificationUncertainInput(_SparseEP):
    """Sparse probit classification with Gaussian input uncertainty
    (sparse_gp_classification.py:103): q(x_n) = N(X_n, X_variance_n), EPDTC on
    the RBF psi statistics (Kmn -> psi1^T in the sweeps, EPDTC.inference :460;
    per-point psi0 and psi2n in the bound, :243-248). Test inputs are certain.
    RBF only. ``X_variance`` is the known input noise and stays fixed in
    ``optimize``."""

    kern: object = None
    Z: torch.Tensor = None
    X: torch.Tensor = None           # the mean of q(X)
    X_variance: torch.Tensor = None  # (N, D)
    Y: torch.Tensor = None
    inference_mode: str = "parallel"
    max_sweeps: int = 60
    _fix = ("X_variance",)

    @classmethod
    def create(cls, X, X_variance, Y, kernel=None, num_inducing=10, Z=None,
               inference_mode="parallel", max_sweeps=60, seed=0, dtype=None,
               device=None) -> "SparseGPClassificationUncertainInput":
        X, Y, kernel = _data(X, Y, kernel, dtype, device)
        S = torch.as_tensor(np.asarray(X_variance, dtype=float), dtype=X.dtype,
                            device=X.device).expand(X.shape).clone()
        return cls(kern=kernel, Z=_inducing(X, Z, num_inducing, seed), X=X, Y=Y,
                   inference_mode=inference_mode, max_sweeps=max_sweeps, X_variance=S)

    def _stats(self):
        _, psi1, psi2n = rbf_psi_stats_n(self.kern, self.Z, self.X, self.X_variance)
        # psi0_n = <k(x_n, x_n)> = variance for the RBF (rbf_psi_comp)
        psi0n = self.kern.variance.expand(self.X.shape[0])
        return self.kern.K(self.Z), psi1.mT, psi0n, psi2n

"""Stochastic variational GP (twin of ``gaussian_process_optimization_tpu/models/svgp.py``;
GPy core/svgp.py:11, inference/latent_function_inference/svgp.py:10).

Whitened q(u) = N(Lm q_mu, Lm S S^T Lm^T) with S packed flat
(``ops/choleskies``); ELBO = (N / batch) sum_n E_q[log p(y_n | f_n)] - KL(q(v) ||
N(0, I)), the expectation in closed form for the Gaussian likelihood and by
20-point Gauss-Hermite otherwise. Trained by minibatch Adam on the packed
parameter vector (the kernel, the noise, Z, q_mu, q_sqrt): ``torch.optim.Adam``
with optax's ``adam`` update (the same betas; eps added after the square root
of the bias-corrected second moment).

Kmm = K(Z, Z) and Kmn = K(Z, X_batch) come from the kernel's own ``K``, so a
stationary kernel in float32 at M = 256 launches the CUDA K build for both and
its backward for Z's gradient (Kmm's both passes, Kmn's row pass).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..ops.choleskies import flat_to_triang, triang_to_flat
from .gp import LOG_2_PI
from .laplace import as_inputs
from .likelihoods import GaussianLik
from .parameters import make_packer


@dataclasses.dataclass(frozen=True)
class SVGP:
    kern: Kernel = None
    likelihood_variance: torch.Tensor = None
    Z: torch.Tensor = None            # (M, D)
    q_mu: torch.Tensor = None         # (M, P) whitened mean
    q_sqrt_flat: torch.Tensor = None  # (M(M+1)/2, P) packed whitened Cholesky
    num_data: torch.Tensor | int = 0
    # a non-Gaussian likelihood (by quadrature, core/svgp.py); None is the
    # closed-form Gaussian one
    likelihood: object = None

    @classmethod
    def create(cls, X, Y, kernel=None, num_inducing=20, Z=None, noise_var=0.1, seed=0,
               likelihood=None, dtype=None, device=None) -> "SVGP":
        """Z a seeded random subset of X unless given; ``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        X = np.atleast_2d(np.asarray(X, dtype=float))
        Y = np.asarray(Y, dtype=float).reshape(len(X), -1)
        n, d = X.shape
        p = Y.shape[1]
        if kernel is None:
            kernel = RBF.create(d, **new)
        if Z is None:
            Z = X[np.random.default_rng(seed).permutation(n)[:num_inducing]].copy()
        Z = torch.atleast_2d(torch.as_tensor(np.asarray(Z, dtype=float), **new))
        m = Z.shape[0]
        eye = torch.eye(m, **new)[None].expand(p, m, m)
        return cls(kern=kernel, likelihood_variance=torch.as_tensor(noise_var, **new).reshape(()),
                   Z=Z, q_mu=torch.zeros((m, p), **new), q_sqrt_flat=triang_to_flat(eye),
                   num_data=torch.as_tensor(float(n), **new), likelihood=likelihood)

    def _q_sqrt(self):
        return flat_to_triang(self.q_sqrt_flat, self.Z.shape[0])  # (P, M, M)

    def kl(self):
        """KL(q(v) || N(0, I)) in whitened coordinates."""
        Ls = self._q_sqrt()
        m, p = self.q_mu.shape
        logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(Ls, dim1=-2, dim2=-1))))
        return 0.5 * (torch.sum(torch.square(Ls)) + torch.sum(torch.square(self.q_mu))
                      - m * p - logdet)

    def _predict_f(self, X, full_cov=False):
        """q(f(X)) under the whitened q(u)."""
        m = self.Z.shape[0]
        Kmm = self.kern.K(self.Z) + 1e-6 * torch.eye(m, dtype=self.Z.dtype, device=self.Z.device)
        Lm, _, _ = linalg.jitchol(Kmm)
        A = linalg.solve_lower(Lm, self.kern.K(self.Z, X))  # (M, B)
        mu = A.mT @ self.q_mu
        SA = torch.einsum("pmk,kb->pmb", self._q_sqrt().mT, A)  # Ls^T A
        if full_cov:
            return mu, self.kern.K(X) - A.mT @ A + torch.einsum("pmb,pmc->bc", SA, SA)
        var = (self.kern.Kdiag(X)[:, None] - torch.sum(torch.square(A), dim=0)[:, None]
               + torch.sum(torch.square(SA), dim=1).mT)
        return mu, torch.clamp(var, min=1e-15)

    def _expected_log_lik(self, Y_batch, mu, var):
        """E_q[log p(y|f)]: closed form for the Gaussian, Gauss-Hermite otherwise."""
        if self.likelihood is None:
            sigma2 = self.likelihood_variance + config.noise_jitter
            return (-0.5 * (LOG_2_PI + torch.log(sigma2))
                    - 0.5 * (torch.square(Y_batch - mu) + var) / sigma2)
        gh_x, gh_w = np.polynomial.hermite.hermgauss(20)
        gh_x = torch.as_tensor(gh_x, dtype=mu.dtype, device=mu.device)
        gh_w = torch.as_tensor(gh_w, dtype=mu.dtype, device=mu.device) / math.sqrt(math.pi)
        f = mu[..., None] + torch.sqrt(2.0 * var[..., None]) * gh_x
        return torch.sum(gh_w * self.likelihood.logpdf(f, Y_batch[..., None]), dim=-1)

    def elbo(self, X_batch, Y_batch, batch_mask=None):
        """The minibatch evidence lower bound."""
        mu, var = self._predict_f(X_batch)
        ell = self._expected_log_lik(Y_batch, mu, var)
        if batch_mask is not None:
            ell = ell * batch_mask[:, None]
            b = torch.clamp(torch.sum(batch_mask), min=1.0)
        else:
            b = max(X_batch.shape[0], 1.0)
        return self.num_data / b * torch.sum(ell) - self.kl()

    def log_likelihood(self, X, Y):
        """The full-data bound (GPy SVGP.log_likelihood)."""
        return self.elbo(X, Y)

    def _gaussian(self):
        return self.likelihood if self.likelihood is not None else GaussianLik(
            variance=self.likelihood_variance)

    def predict(self, Xnew, include_likelihood=True, full_cov=False):
        mu, var = self._predict_f(as_inputs(Xnew, self.Z), full_cov=full_cov)
        if not include_likelihood:
            return mu, var
        if self.likelihood is not None:
            if full_cov:
                raise NotImplementedError(
                    "full_cov predictive through a non-Gaussian likelihood has no closed "
                    "form; use include_likelihood=False for the latent covariance")
            ey, vy = self.likelihood.predictive(mu[:, 0], var[:, 0])
            return ey[:, None], vy[:, None]
        if full_cov:
            return mu, var + self.likelihood_variance * torch.eye(
                var.shape[0], dtype=var.dtype, device=var.device)
        return mu, var + self.likelihood_variance

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), rng=None, draws=None):
        """Predictive quantiles through the likelihood (GPy gp.py:384): the
        Gaussian closed form, or the sampling fallback. Percent; a list of
        ``(M, 1)`` tensors."""
        mu, var = self._predict_f(as_inputs(Xnew, self.Z))
        return self._gaussian().predictive_quantiles(mu[:, 0], var[:, 0], quantiles, rng=rng,
                                                     draws=draws)

    def log_predictive_density(self, x_test, y_test, gh_points=32):
        """Per-point log p(y*|D) through the likelihood (GPy gp.py:680)."""
        mu, var = self._predict_f(as_inputs(x_test, self.Z))
        y = as_inputs(y_test, self.Z)
        return self._gaussian().log_predictive_density(y[:, 0], mu[:, 0], var[:, 0],
                                                       gh_points=gh_points)[:, None]


def make_svgp_train_step(optimizer=None, learning_rate=1e-2):
    """A factory of optimizer steps on -ELBO over the packed trainable leaves
    (the kernel, the noise, Z, q_mu, q_sqrt). ``optimizer`` takes the list of
    parameters and returns a ``torch.optim.Optimizer`` (the reference's is an
    optax transformation), e.g. ``lambda p: torch.optim.SGD(p, lr=0.1)``; by
    default Adam at ``learning_rate`` with optax's betas and eps.
    ``make(model)`` returns ``(packer, u, optimizer, step)``; ``step(X_batch,
    Y_batch)`` takes one step on ``u`` in place and returns -ELBO before it."""

    def make(model):
        packer = make_packer(model, fix=("num_data",))
        u = packer.pack(model).detach().clone().requires_grad_(True)
        if optimizer is None:
            # optax adam's defaults: b1 0.9, b2 0.999, eps 1e-8 after the square root
            opt = torch.optim.Adam([u], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        else:
            opt = optimizer([u])

        def step(X_batch, Y_batch):
            opt.zero_grad(set_to_none=True)
            loss = -packer.unpack(u, reference=model).elbo(X_batch, Y_batch)
            loss.backward()
            opt.step()
            return loss.detach()

        return packer, u, opt, step

    return make


def fit_svgp(model, X, Y, num_steps=500, batch_size=None, learning_rate=1e-2,
             generator: torch.Generator | None = None, indices=None):
    """Minibatch SVI (the reference's training loop): each step draws
    ``batch_size`` rows without replacement, from ``generator`` (a seeded one
    on the data's device by default), or takes row ``i`` of ``indices``
    ``(num_steps, batch_size)`` when given. Returns ``(fitted, losses)``, the
    -ELBO before each step as numpy."""
    X = as_inputs(X, model.Z)
    Y = as_inputs(Y, model.Z).reshape(X.shape[0], -1)
    n = X.shape[0]
    batch_size = batch_size or min(n, 256)
    if indices is None and generator is None:
        generator = torch.Generator(device=X.device).manual_seed(0)
    packer, u, _, step = make_svgp_train_step(learning_rate=learning_rate)(model)
    losses = []
    for i in range(num_steps):
        if indices is not None:
            idx = torch.as_tensor(np.asarray(indices[i]), device=X.device)
        else:
            idx = torch.randperm(n, generator=generator, device=X.device)[:batch_size]
        losses.append(step(X[idx], Y[idx]))
    with torch.no_grad():
        fitted = packer.unpack(u.detach(), reference=model)
    return fitted, torch.stack(losses).cpu().numpy() if losses else np.zeros(0)

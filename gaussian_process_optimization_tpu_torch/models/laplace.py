"""Laplace approximation for non-Gaussian likelihoods (twin of
``gaussian_process_optimization_tpu/models/laplace.py``; GPy
inference/latent_function_inference/laplace.py:122).

GPML Algorithm 3.1: Newton steps on the mode of p(y|f) N(f; 0, K) in the
W^1/2 parameterization. The Newton loop runs without autograd; then two
differentiable Newton steps from the detached mode give the gradient, as the
reference argues (laplace.py:63-74): the Newton map's Jacobian in f vanishes at
the fixed point, so the first step carries the implicit derivative of the mode,
and the second evaluates W, L and a at a differentiable mode, so the log
determinant and the quadratic term get the dW/df chain (one step leaves a
first-order hole).

B = I + W^1/2 K W^1/2 is factored in float64 and its factor rounded to K's
dtype (``linalg.jitchol_f64``), as dense EP factors its B: the float32 Newton
loop otherwise rounds B's trailing pivots, ~1 under a diagonal of W_ii K_ii.

``K`` may carry a lane axis (the Fitter's restarts): each lane iterates until
its own step falls below the tolerance and is then held, as each lane of the
reference's vmapped ``while_loop`` stops on its own condition.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from .likelihoods import Bernoulli, Likelihood


@dataclasses.dataclass(frozen=True)
class LaplacePosterior:
    f_hat: torch.Tensor = None
    W: torch.Tensor = None
    L: torch.Tensor = None     # chol(I + W^1/2 K W^1/2)
    grad: torch.Tensor = None  # dlogp(y | f_hat)
    lml: torch.Tensor = None
    iterations: torch.Tensor = None  # Newton steps each lane took in the loop


def as_inputs(x, like: torch.Tensor) -> torch.Tensor:
    """Test inputs (array or tensor) as a 2-D tensor like ``like``."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=float)
    return torch.atleast_2d(torch.as_tensor(x, dtype=like.dtype, device=like.device))


def _mv(K, v):
    return (K @ v[..., None])[..., 0]


def laplace_inference(K, y, likelihood: Likelihood, maxiter=50, tol=1e-9) -> LaplacePosterior:
    """GPML Alg. 3.1: the mode of p(y|f) N(f; 0, K) and the Laplace evidence.
    ``K (..., N, N)``, ``y (N,)``."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)

    def newton(f):
        W = torch.clamp(-likelihood.d2logpdf_df2(f, y), min=1e-12)
        sW = torch.sqrt(W)
        L = linalg.jitchol_f64(eye + sW[..., :, None] * K * sW[..., None, :])
        b = W * f + likelihood.dlogpdf_df(f, y)
        tmp = linalg.cho_solve(L, (sW * _mv(K, b))[..., None])[..., 0]
        a = b - sW * tmp
        return _mv(K, a), a, W, sW, L

    lanes = K.shape[:-2]
    with torch.no_grad():
        f = torch.zeros(lanes + (n,), dtype=K.dtype, device=K.device)
        it = torch.zeros(lanes, dtype=torch.int64, device=K.device)
        active = torch.ones(lanes, dtype=torch.bool, device=K.device)
        for _ in range(maxiter):
            f_new = newton(f)[0]
            diff = torch.amax(torch.abs(f_new - f), dim=-1)
            f = torch.where(active[..., None], f_new, f)
            it = it + active.to(it.dtype)
            active = active & (diff > tol)
            if not bool(active.any()):
                break
    f_hat, a, W, sW, L = newton(newton(f)[0])
    lml = (-0.5 * torch.sum(a * f_hat, dim=-1)
           + torch.sum(likelihood.logpdf(f_hat, y), dim=-1)
           - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1))
    return LaplacePosterior(f_hat=f_hat, W=W, L=L, grad=likelihood.dlogpdf_df(f_hat, y),
                            lml=lml, iterations=it)


@dataclasses.dataclass(frozen=True)
class GPLaplace:
    """A GP with a non-Gaussian likelihood through Laplace (GPy core.GP with
    inference_method=Laplace; Bernoulli by default, gp_classification.py)."""

    kern: Kernel = None
    likelihood: Likelihood = None
    X: torch.Tensor = None
    Y: torch.Tensor = None

    @classmethod
    def create(cls, X, Y, kernel=None, likelihood=None, dtype=None, device=None) -> "GPLaplace":
        """``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        X = torch.as_tensor(np.atleast_2d(np.asarray(X, dtype=float)), dtype=dtype, device=device)
        Y = torch.as_tensor(np.asarray(Y, dtype=float).reshape(-1), dtype=dtype, device=device)
        if kernel is None:
            kernel = RBF.create(X.shape[1], dtype=dtype, device=device)
        return cls(kern=kernel, likelihood=likelihood if likelihood is not None else Bernoulli(),
                   X=X, Y=Y)

    def inference(self) -> LaplacePosterior:
        return laplace_inference(self.kern.K(self.X), self.Y, self.likelihood)

    def log_marginal_likelihood(self):
        return self.inference().lml

    def _raw_predict(self, Xnew, posterior: LaplacePosterior | None = None):
        post = posterior if posterior is not None else self.inference()
        Xnew = as_inputs(Xnew, self.X)
        Ks = self.kern.K(self.X, Xnew)
        mu = Ks.mT @ post.grad
        v = linalg.solve_lower(post.L, torch.sqrt(post.W)[:, None] * Ks)
        var = torch.clamp(self.kern.Kdiag(Xnew) - torch.sum(torch.square(v), 0), min=1e-15)
        return mu, var

    def predict(self, Xnew, posterior: LaplacePosterior | None = None):
        """Predictive mean and variance of y*, the latent pushed through the
        likelihood (GPy likelihood.predictive_values)."""
        mu, var = self._raw_predict(Xnew, posterior)
        return self.likelihood.predictive(mu, var)

    def predict_latent(self, Xnew):
        return self._raw_predict(Xnew)

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), rng=None,
                          posterior: LaplacePosterior | None = None, *, draws=None):
        """Predictive quantiles through the likelihood (GPy gp.py:384), in
        percent; a list of ``(M, 1)`` tensors."""
        mu, var = self._raw_predict(Xnew, posterior)
        return self.likelihood.predictive_quantiles(mu, var, quantiles, rng=rng, draws=draws)

    def log_predictive_density(self, x_test, y_test, gh_points=32):
        """Per-point log p(y*|D) by quadrature over the latent Laplace marginal
        (GPy gp.py:680)."""
        mu, var = self._raw_predict(x_test)
        y = torch.as_tensor(np.asarray(y_test, dtype=float).reshape(-1), dtype=mu.dtype,
                            device=mu.device)
        return self.likelihood.log_predictive_density(y, mu, var, gh_points=gh_points)

    def posterior_samples(self, Xnew, size, rng=None, full_cov=False):
        """Observation draws: latent draws corrupted through the likelihood
        (GPy gp.py posterior_samples:611), ``(M, size)``; ``rng`` a numpy
        Generator."""
        rng = np.random.default_rng(0) if rng is None else rng
        Xnew = as_inputs(Xnew, self.X)
        post = self.inference()
        mu, var = self._raw_predict(Xnew, post)
        z = torch.as_tensor(rng.standard_normal((Xnew.shape[0], size)), dtype=mu.dtype,
                            device=mu.device)
        if full_cov:
            Ks = self.kern.K(self.X, Xnew)
            v = linalg.solve_lower(post.L, torch.sqrt(post.W)[:, None] * Ks)
            cov = self.kern.K(Xnew) - v.mT @ v
            cov = cov + 1e-10 * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
            Lc, _, _ = linalg.jitchol(cov)
            f = mu[:, None] + Lc @ z
        else:
            f = mu[:, None] + torch.sqrt(var)[:, None] * z
        return self.likelihood.samples(f, rng)


GPClassification = GPLaplace  # the Bernoulli default is GPy's GPClassification

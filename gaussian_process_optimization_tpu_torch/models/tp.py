"""Student-t process regression (twin of
``gaussian_process_optimization_tpu/models/tp.py``; GPy models/tp_regression.py).

The exact GP's kernel machinery with a multivariate-t marginal of deg_free nu:
the evidence gains Gamma-function terms and a log-quadratic data term, and the
predictive covariance is scaled by (nu + beta - 2) / (nu + n - 2) with
beta = y^T K^-1 y (Shah et al. 2014). The evidence takes the lane axis of
lane-batched hyperparameters (the Fitter's restarts).
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
from .laplace import as_inputs

LOG_PI = math.log(math.pi)


@dataclasses.dataclass(frozen=True)
class TPRegression:
    kern: Kernel = None
    deg_free: torch.Tensor = None  # nu > 2
    X: torch.Tensor = None
    Y: torch.Tensor = None

    @classmethod
    def create(cls, X, Y, kernel=None, deg_free=5.0, dtype=None, device=None) -> "TPRegression":
        """``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        X = torch.as_tensor(np.atleast_2d(np.asarray(X, dtype=float)), dtype=dtype, device=device)
        Y = np.asarray(Y, dtype=float)
        Y = torch.as_tensor(Y[:, None] if Y.ndim == 1 else Y, dtype=dtype, device=device)
        if kernel is None:
            kernel = RBF.create(X.shape[1], dtype=dtype, device=device)
        return cls(kern=kernel, deg_free=torch.as_tensor(deg_free, dtype=dtype,
                                                         device=device).reshape(()), X=X, Y=Y)

    def _factor(self):
        K = self.kern.K(self.X)
        n = K.shape[-1]
        K = K + config.noise_jitter * torch.eye(n, dtype=K.dtype, device=K.device)
        L, _, ok = linalg.jitchol(K)
        alpha = linalg.cho_solve(L, self.Y)
        beta = torch.sum(alpha * self.Y, dim=(-2, -1))
        return L, alpha, beta, ok

    def log_marginal_likelihood(self):
        """The multivariate-t log density (tp_regression.py log_likelihood)."""
        n = self.X.shape[0]
        nu = self.deg_free
        L, _, beta, _ = self._factor()
        return (torch.lgamma((nu + n) / 2.0) - torch.lgamma(nu / 2.0)
                - 0.5 * n * (torch.log(nu - 2.0) + LOG_PI)
                - 0.5 * linalg.logdet_from_chol(L)
                - 0.5 * (nu + n) * torch.log1p(beta / (nu - 2.0)))

    def predict(self, Xnew, full_cov=False):
        """The predictive t's moments: the GP mean, the covariance scaled by
        (nu + beta - 2) / (nu + n - 2) (tp_regression.py predict)."""
        n = self.X.shape[0]
        nu = self.deg_free
        L, alpha, beta, _ = self._factor()
        Xnew = as_inputs(Xnew, self.X)
        Ks = self.kern.K(self.X, Xnew)
        mu = Ks.mT @ alpha
        tmp = linalg.solve_lower(L, Ks)
        scale = (nu + beta - 2.0) / (nu + n - 2.0)
        if full_cov:
            return mu, scale * linalg.symmetrify(self.kern.K(Xnew) - tmp.mT @ tmp)
        var = torch.clamp(self.kern.Kdiag(Xnew) - torch.sum(torch.square(tmp), 0), min=1e-15)
        return mu, (scale * var)[:, None]

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5)):
        """Student-t predictive quantiles (tp_regression.py:232-251): mu +
        t_ppf(q / 100, df) sqrt(var), df = nu + N (GPy's deg_free is nu - 2,
        this nu is the effective one); scipy's t on the host."""
        from scipy.stats import t as student_t

        mu, var = self.predict(Xnew)
        df = float(self.deg_free) + self.X.shape[0]
        sd = torch.sqrt(var)
        return [mu + float(student_t.ppf(q / 100.0, df)) * sd for q in quantiles]

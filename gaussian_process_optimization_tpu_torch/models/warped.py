"""Warped GPs (twin of ``gaussian_process_optimization_tpu/models/warped.py``).

- :class:`WarpedGP` (GPy models/warped_gp.py, util/warping_functions.py
  ``TanhFunction``:71): a monotone warp of the outputs, by default
  f(y) = y d + sum_i a_i tanh(b_i (y + c_i)); the LML of the GP on z = f(y) plus
  sum log f'(y). Prediction inverts the warp (Newton steps) for the median and
  integrates it by Gauss-Hermite quadrature for the mean (warped_gp.py predict).
- :class:`InputWarpedGP` (GPy models/input_warped_gp.py,
  util/input_warping_functions.py ``KumarWarping``): the Kumaraswamy CDF on each
  listed input, x' = 1 - (1 - u^a)^b with u the min-max scaled input; an exact GP
  on the warped inputs, a and b trainable.

Both take the lane axis in their warp's leaves as in the GP's (the Fitter's
restarts).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from .gp import GPRegression


def _lane(v):
    """A per-lane scalar shaped to broadcast against a trailing data axis."""
    return v[..., None]


@dataclasses.dataclass(frozen=True)
class TanhWarp:
    """f(y) = y d + sum_i a_i tanh(b_i (y + c_i)), GPy ``TanhFunction`` (a, b,
    d positive)."""

    d: torch.Tensor = None
    a: torch.Tensor = None
    b: torch.Tensor = None
    c: torch.Tensor = None

    @classmethod
    def create(cls, n_terms=3, dtype=None, device=None):
        device = resolve_device(device)
        new = dict(dtype=resolve_dtype(dtype, device), device=device)
        return cls(d=torch.ones((), **new), a=torch.ones((n_terms,), **new),
                   b=torch.ones((n_terms,), **new), c=torch.zeros((n_terms,), **new))

    def _tanh(self, y):
        return torch.tanh(self.b[..., None, :] * (y[..., None] + self.c[..., None, :]))

    def f(self, y):
        return y * _lane(self.d) + torch.sum(self.a[..., None, :] * self._tanh(y), dim=-1)

    def fgrad_y(self, y):
        t = self._tanh(y)
        return _lane(self.d) + torch.sum(self.a[..., None, :] * self.b[..., None, :]
                                         * (1.0 - torch.square(t)), dim=-1)

    def f_inv(self, z, iters=30):
        """Newton's iteration from z / d (GPy warping_functions f_inv)."""
        y = z / self.d
        for _ in range(iters):
            y = y - (self.f(y) - z) / torch.clamp(self.fgrad_y(y), min=1e-10)
        return y


@dataclasses.dataclass(frozen=True)
class LogWarp:
    """f(y) = log y, GPy ``LogFunction`` (warping_functions.py:172-200); no
    parameters."""

    def f(self, y):
        return torch.log(y)

    def fgrad_y(self, y):
        return 1.0 / y

    def f_inv(self, z, iters=None):
        return torch.exp(z)


@dataclasses.dataclass(frozen=True)
class IdentityWarp:
    """GPy ``IdentityFunction`` (warping_functions.py:203-230)."""

    def f(self, y):
        return y

    def fgrad_y(self, y):
        return torch.ones_like(y)

    def f_inv(self, z, iters=None):
        return z


@dataclasses.dataclass(frozen=True)
class WarpedGP:
    """The GP on z = warp(Y) with the warp's Jacobian in the LML
    (warped_gp.py:62-78). ``gp`` holds the raw targets."""

    gp: GPRegression = None
    warp: object = None

    @classmethod
    def create(cls, X, Y, kernel=None, noise_var=1.0, warping_terms=3, max_points=None,
               warping_function=None, dtype=None, device=None) -> "WarpedGP":
        """``warping_function``: any warp with f / fgrad_y / f_inv (a
        :class:`TanhWarp` of ``warping_terms`` terms by default)."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        Y = np.asarray(Y, dtype=float)
        Y = Y[:, None] if Y.ndim == 1 else Y
        warp = (warping_function if warping_function is not None
                else TanhWarp.create(warping_terms, dtype=dtype, device=device))
        gp = GPRegression.create(X, Y, kernel=kernel, noise_var=noise_var,
                                 max_points=max_points, dtype=dtype, device=device)
        return cls(gp=gp, warp=warp)

    def _safe_y(self):
        """The targets with the padded rows set to 1: a warp with a restricted
        domain (log) would otherwise put 0 * inf = NaN into the masked LML."""
        y = self.gp.Y[..., 0]
        if self.gp.mask is not None:
            y = torch.where(self.gp.mask > 0, y, torch.ones_like(y))
        return y

    def _warped_gp(self) -> GPRegression:
        Z = self.warp.f(self._safe_y())[..., None]
        if self.gp.mask is not None:
            Z = Z * self.gp.mask[:, None]
        return dataclasses.replace(self.gp, Y=Z)

    def log_marginal_likelihood(self):
        lml = self._warped_gp().log_marginal_likelihood()
        jac = torch.log(torch.clamp(self.warp.fgrad_y(self._safe_y()), min=1e-300))
        if self.gp.mask is not None:
            jac = torch.where(self.gp.mask > 0, jac, torch.zeros_like(jac))
        return lml + torch.sum(jac, dim=-1)

    def posterior_cache(self):
        """(warped-space GP, its posterior): one factorization, for
        ``predict(posterior=...)``."""
        gp_z = self._warped_gp()
        return gp_z, gp_z.inference()

    def predict(self, Xnew, median=False, include_likelihood=True, gh_points=20,
                posterior=None):
        """Predict in warped space, then un-warp: the median is f_inv(mu); the
        mean and variance integrate f_inv by Gauss-Hermite quadrature
        (warped_gp.py predict:110)."""
        gp_z, post = self.posterior_cache() if posterior is None else posterior
        mu, var = gp_z.predict(Xnew, include_likelihood=include_likelihood, posterior=post)
        if median:
            return self.warp.f_inv(mu), var
        gh_x, gh_w = np.polynomial.hermite.hermgauss(gh_points)
        gh_x = torch.as_tensor(gh_x, dtype=mu.dtype, device=mu.device)
        gh_w = torch.as_tensor(gh_w / np.sqrt(np.pi), dtype=mu.dtype, device=mu.device)
        y = self.warp.f_inv(mu[..., None] + torch.sqrt(2.0 * var[..., None]) * gh_x)
        mean = torch.sum(gh_w * y, dim=-1)
        second = torch.sum(gh_w * torch.square(y), dim=-1)
        return mean, torch.clamp(second - torch.square(mean), min=1e-15)

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), posterior=None):
        """Gaussian quantiles in warped space through f_inv (warped_gp.py
        predict_quantiles:118-131), in percent."""
        gp_z, post = self.posterior_cache() if posterior is None else posterior
        return [self.warp.f_inv(q) for q in gp_z.predict_quantiles(
            Xnew, quantiles=quantiles, posterior=post)]

    def log_predictive_density(self, x_test, y_test):
        """log p(y* | D): the latent density at f(y*) plus the warp's log
        Jacobian (warped_gp.py log_predictive_density:143-160)."""
        gp_z, post = self.posterior_cache()
        y = torch.as_tensor(np.atleast_2d(np.asarray(y_test, dtype=float)),
                            dtype=gp_z.X.dtype, device=gp_z.X.device)
        fy = self.warp.f(y[:, 0])[:, None]
        lpd = gp_z.log_predictive_density(x_test, fy, posterior=post)
        return lpd + torch.log(self.warp.fgrad_y(y[:, 0]))[:, None]


@dataclasses.dataclass(frozen=True)
class KumarWarp:
    """x' = 1 - (1 - u^a)^b per listed input, u the input min-max scaled into
    (0, 1) (GPy input_warping_functions.py ``KumarWarping``); a, b positive, one
    per listed input."""

    a: torch.Tensor = None
    b: torch.Tensor = None
    lo: torch.Tensor = None
    hi: torch.Tensor = None
    dims: tuple = None

    @classmethod
    def create(cls, X, dims=None, dtype=None, device=None):
        device = resolve_device(device)
        new = dict(dtype=resolve_dtype(dtype, device), device=device)
        X = np.atleast_2d(np.asarray(X, dtype=float))
        dims = tuple(range(X.shape[1])) if dims is None else tuple(int(d) for d in dims)
        return cls(a=torch.ones((len(dims),), **new), b=torch.ones((len(dims),), **new),
                   lo=torch.as_tensor(X.min(0) - 1e-9, **new),
                   hi=torch.as_tensor(X.max(0) + 1e-9, **new), dims=dims)

    def f(self, X):
        """Warp the listed columns of ``X (N, D)``; lane-batched a and b give
        ``(B, N, D)``."""
        u = torch.clamp((X - self.lo) / (self.hi - self.lo), 1e-9, 1.0 - 1e-9)
        cols = list(X.unbind(-1))
        for i, dim in enumerate(self.dims):
            a, b = _lane(self.a[..., i]), _lane(self.b[..., i])
            cols[dim] = 1.0 - (1.0 - u[..., dim] ** a) ** b
        return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


@dataclasses.dataclass(frozen=True)
class InputWarpedGP:
    """An exact GP over Kumaraswamy-warped inputs (input_warped_gp.py:9); ``gp``
    holds the raw inputs."""

    gp: GPRegression = None
    warp: KumarWarp = None

    @classmethod
    def create(cls, X, Y, kernel=None, noise_var=1.0, warping_indices=None, max_points=None,
               dtype=None, device=None) -> "InputWarpedGP":
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        warp = KumarWarp.create(X, dims=warping_indices, dtype=dtype, device=device)
        gp = GPRegression.create(X, Y, kernel=kernel, noise_var=noise_var,
                                 max_points=max_points, dtype=dtype, device=device)
        return cls(gp=gp, warp=warp)

    def _warped(self) -> GPRegression:
        return dataclasses.replace(self.gp, X=self.warp.f(self.gp.X))

    def log_marginal_likelihood(self):
        return self._warped().log_marginal_likelihood()

    def posterior_cache(self):
        gp_w = self._warped()
        return gp_w, gp_w.inference()

    def predict(self, Xnew, include_likelihood=True, posterior=None):
        gp_w, post = self.posterior_cache() if posterior is None else posterior
        return gp_w.predict(self.warp.f(Xnew), include_likelihood=include_likelihood,
                            posterior=post)

"""Static kernels: White, Bias, WhiteHeteroscedastic, Fixed (twin of
``gaussian_process_optimization_tpu/kernels/static.py``; GPy static.py:63, 137,
177).

Lanes: ``variance`` of shape ``lanes``; ``variances`` of ``lanes + (N,)``. ``K``
returns ``lanes + (N, M)``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Kernel, as_leaf, dims_of, grid, placement


def _zeros(X, X2):
    return X.new_zeros(X.shape[:-1] + (X2.shape[-2],))


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """White noise: sigma^2 I when X2 is None, else 0 (GPy static.py:63)."""

    variance: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, variance=1.0, active_dims=None, dtype=None, device=None):
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **placement(dtype, device)).reshape(()))

    def K(self, X, X2=None):
        if X2 is None:
            n = X.shape[-2]
            return grid(self.variance) * torch.eye(n, dtype=X.dtype, device=X.device)
        return _zeros(X, X2)

    def Kdiag(self, X):
        return self.variance[..., None] * torch.ones(X.shape[:-1], dtype=X.dtype,
                                                     device=X.device)


@dataclasses.dataclass(frozen=True)
class Bias(Kernel):
    """Constant covariance sigma^2 (GPy static.py:137)."""

    variance: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, variance=1.0, active_dims=None, dtype=None, device=None):
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **placement(dtype, device)).reshape(()))

    def K(self, X, X2=None):
        m = X.shape[-2] if X2 is None else X2.shape[-2]
        return grid(self.variance) * X.new_ones(X.shape[:-1] + (m,))

    def Kdiag(self, X):
        return self.variance[..., None] * X.new_ones(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class WhiteHeteroscedastic(Kernel):
    """Per-point noise: K(X_train) = diag(variances), zero off the training
    set (GPy static.py WhiteHeteroscedastic)."""

    variances: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, num_data, variance=1.0, active_dims=None, dtype=None,
               device=None):
        v = as_leaf(variance, **placement(dtype, device))
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variances=v.expand(num_data).clone())

    def K(self, X, X2=None):
        if X2 is None:
            return torch.diag_embed(self.variances.expand(
                self.variances.shape[:-1] + (X.shape[-2],)))
        return _zeros(X, X2)

    def Kdiag(self, X):
        return self.variances.expand(self.variances.shape[:-1] + (X.shape[-2],))


@dataclasses.dataclass(frozen=True)
class Fixed(Kernel):
    """A fixed covariance matrix scaled by a variance, defined on the
    training set only: K(X) = variance * fixed_K (GPy static.py:177)."""

    variance: torch.Tensor = None
    fixed_K: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, fixed_K, variance=1.0, active_dims=None, dtype=None,
               device=None):
        where = placement(dtype, device)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **where).reshape(()),
                   fixed_K=as_leaf(fixed_K, **where))

    def K(self, X, X2=None):
        if X2 is None:
            return grid(self.variance) * self.fixed_K
        return _zeros(X, X2)

    def Kdiag(self, X):
        return self.variance[..., None] * torch.diagonal(self.fixed_K)

"""StandardPeriodic, MLP, Poly, Brownian, Spline and Coregionalize (twin of
``gaussian_process_optimization_tpu/kernels/other.py``; GPy
standard_periodic.py:21, mlp.py:11, poly.py:10, brownian.py:9, spline.py,
coregionalize.py:18).

Lanes: every scalar hyperparameter has shape ``lanes``; an ARD one
``lanes + (D,)`` (the static ``ard*`` flags say which); ``Coregionalize.W`` is
``lanes + (T, rank)`` and ``kappa`` ``lanes + (T,)``. ``K`` returns
``lanes + (N, M)``. Differences over the input dimensions are reduced one
dimension at a time, so no ``(N, M, D)`` buffer is formed.

``Coregionalize.K`` is the gather B[i1][:, i2] of the reference written as
E1 B E2^T with one-hot rows E: its backward is dB = E1^T G E2, two matmuls
(a gather's backward would scatter-add with atomics, in no fixed order). The
task index is the rounded column, so the column itself gets an exactly-zero
gradient, as in the reference; an index past either end takes the nearest
task, as JAX's clamped gather does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import Kernel, as_leaf, dims_of, grid, placement


def _per_dim(v, d, ard):
    """Dimension ``d``'s value of a per-lane hyperparameter, ``grid``-shaped."""
    return grid(v[..., d] if ard else v)


def _col(X, X2):
    """The first columns as an (N, 1) by (1, M) pair."""
    return X[..., :, None, 0], X2[..., None, :, 0]


@dataclasses.dataclass(frozen=True)
class StandardPeriodic(Kernel):
    """K = sigma^2 exp(-0.5 sum_d (sin(pi (x_d - x'_d) / T_d) / l_d)^2)."""

    variance: torch.Tensor = None
    period: torch.Tensor = None
    lengthscale: torch.Tensor = None
    ard1: bool = False
    ard2: bool = False

    @classmethod
    def create(cls, input_dim, variance=1.0, period=1.0, lengthscale=1.0, ARD1=False,
               ARD2=False, active_dims=None, dtype=None, device=None):
        where = placement(dtype, device)
        p, l = as_leaf(period, **where), as_leaf(lengthscale, **where)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **where).reshape(()),
                   period=p.expand(input_dim).clone() if ARD1 else p.reshape(()),
                   lengthscale=l.expand(input_dim).clone() if ARD2 else l.reshape(()),
                   ard1=bool(ARD1), ard2=bool(ARD2))

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        acc = 0.0
        for d in range(X.shape[-1]):
            diff = X[..., :, None, d] - X2[..., None, :, d]
            s = (torch.sin(math.pi * diff / _per_dim(self.period, d, self.ard1))
                 / _per_dim(self.lengthscale, d, self.ard2))
            acc = acc + torch.square(s)
        return grid(self.variance) * torch.exp(-0.5 * acc)

    def Kdiag(self, X):
        return self.variance[..., None] * X.new_ones(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class MLP(Kernel):
    """Arc-sine kernel (GPy mlp.py:11):
    sigma^2 (2/pi) asin((w x.x' + b) / sqrt((w x.x + b + 1)(w x'.x' + b + 1)))."""

    variance: torch.Tensor = None
    weight_variance: torch.Tensor = None
    bias_variance: torch.Tensor = None
    ard: bool = False

    @classmethod
    def create(cls, input_dim, variance=1.0, weight_variance=1.0, bias_variance=1.0,
               ARD=False, active_dims=None, dtype=None, device=None):
        where = placement(dtype, device)
        w = as_leaf(weight_variance, **where)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **where).reshape(()),
                   weight_variance=w.expand(input_dim).clone() if ARD else w.reshape(()),
                   bias_variance=as_leaf(bias_variance, **where).reshape(()), ard=bool(ARD))

    def _weighted(self, X, X2):
        if self.ard:
            return (X * self.weight_variance[..., None, :]) @ X2.mT
        return grid(self.weight_variance) * (X @ X2.mT)

    def _self_prod(self, X):
        """w x.x + b per row, ``lanes + (N,)``."""
        sq = torch.square(X)
        if self.ard:
            wx = torch.sum(sq * self.weight_variance[..., None, :], dim=-1)
        else:
            wx = self.weight_variance[..., None] * torch.sum(sq, dim=-1)
        return wx + self.bias_variance[..., None]

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        num = self._weighted(X, X2) + grid(self.bias_variance)
        dX = self._self_prod(X) + 1.0
        dX2 = self._self_prod(X2) + 1.0
        arg = torch.clamp(num / torch.sqrt(dX[..., :, None] * dX2[..., None, :]), -1.0, 1.0)
        return grid(self.variance) * (2.0 / math.pi) * torch.asin(arg)

    def Kdiag(self, X):
        d = self._self_prod(self._slice(X))
        return self.variance[..., None] * (2.0 / math.pi) * torch.asin(d / (d + 1.0))


@dataclasses.dataclass(frozen=True)
class Poly(Kernel):
    """K = sigma^2 (w x.x' + b)^order (GPy poly.py:10)."""

    order: int = 3
    variance: torch.Tensor = None
    weight_variance: torch.Tensor = None
    bias_variance: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, variance=1.0, weight_variance=1.0, bias_variance=1.0,
               order=3, active_dims=None, dtype=None, device=None):
        where = placement(dtype, device)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims), order=int(order),
                   variance=as_leaf(variance, **where).reshape(()),
                   weight_variance=as_leaf(weight_variance, **where).reshape(()),
                   bias_variance=as_leaf(bias_variance, **where).reshape(()))

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        base = grid(self.weight_variance) * (X @ X2.mT) + grid(self.bias_variance)
        return grid(self.variance) * base ** self.order

    def Kdiag(self, X):
        X = self._slice(X)
        base = (self.weight_variance[..., None] * torch.sum(torch.square(X), dim=-1)
                + self.bias_variance[..., None])
        return self.variance[..., None] * base ** self.order


@dataclasses.dataclass(frozen=True)
class Brownian(Kernel):
    """Brownian motion, 1-D: K = sigma^2 min(x, x') (GPy brownian.py:9)."""

    variance: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=1, variance=1.0, active_dims=None, dtype=None, device=None):
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **placement(dtype, device)).reshape(()))

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        return grid(self.variance) * torch.minimum(*_col(X, X2))

    def Kdiag(self, X):
        return self.variance[..., None] * self._slice(X)[..., 0]


@dataclasses.dataclass(frozen=True)
class Spline(Kernel):
    """1-D cubic spline (GPy spline.py):
    sigma^2 (1 + xy + xy min - (x + y)/2 min^2 + min^3 / 3)."""

    variance: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=1, variance=1.0, active_dims=None, dtype=None, device=None):
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **placement(dtype, device)).reshape(()))

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        x, y = _col(X, X2)
        m = torch.minimum(x, y)
        return grid(self.variance) * (1.0 + x * y + x * y * m - 0.5 * (x + y) * torch.square(m)
                                      + torch.pow(m, 3) / 3.0)

    def Kdiag(self, X):
        x = self._slice(X)[..., 0]
        return self.variance[..., None] * (1.0 + torch.square(x) + torch.pow(x, 3) / 3.0)


def task_onehot(col: torch.Tensor, tasks: int) -> torch.Tensor:
    """One-hot rows of the rounded task column, ``(N, T)``; an index below 0
    counts from the end and one past either end takes the nearest task (the
    reference's integer gather)."""
    idx = torch.round(col.detach()).long()
    idx = torch.where(idx < 0, idx + tasks, idx).clamp(0, tasks - 1)
    return torch.nn.functional.one_hot(idx, tasks).to(col.dtype)


@dataclasses.dataclass(frozen=True)
class Coregionalize(Kernel):
    """Intrinsic coregionalization B = W W^T + diag(kappa) over integer task
    indices in the sliced column (GPy coregionalize.py:18)."""

    W: torch.Tensor = None
    kappa: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, output_dim, rank=1, W=None, kappa=None, active_dims=None,
               dtype=None, device=None):
        where = placement(dtype, device)
        W = 0.5 * torch.ones(output_dim, rank, **where) if W is None else as_leaf(W, **where)
        kappa = (0.5 * torch.ones(output_dim, **where) if kappa is None
                 else as_leaf(kappa, **where))
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims), W=W, kappa=kappa)

    @property
    def B(self):
        return self.W @ self.W.mT + torch.diag_embed(self.kappa)

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        tasks = self.kappa.shape[-1]
        E1, E2 = task_onehot(X[..., 0], tasks), task_onehot(X2[..., 0], tasks)
        return (E1 @ self.B) @ E2.mT

    def Kdiag(self, X):
        E = task_onehot(self._slice(X)[..., 0], self.kappa.shape[-1])
        return torch.sum(E * torch.diagonal(self.B, dim1=-2, dim2=-1)[..., None, :], dim=-1)

"""Linear kernels (twin of ``gaussian_process_optimization_tpu/kernels/linear.py``;
GPy linear.py:13, :183).

Lanes: ``Linear.variances`` has shape ``lanes + (D,)`` with ``ard`` (a static
flag: the leaf's own rank says nothing once lanes are added), ``lanes``
without. ``LinearFull.W`` is ``lanes + (D, rank)``, ``kappa`` ``lanes + (D,)``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Kernel, as_leaf, dims_of, grid, placement


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """K = X diag(variances) X2^T."""

    variances: torch.Tensor = None
    ard: bool = False

    @classmethod
    def create(cls, input_dim, variances=1.0, ARD=False, active_dims=None, dtype=None,
               device=None):
        v = as_leaf(variances, **placement(dtype, device))
        v = v.expand(input_dim).clone() if ARD else v.reshape(())
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims), variances=v,
                   ard=bool(ARD))

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        if self.ard:
            return (X * self.variances[..., None, :]) @ X2.mT
        return grid(self.variances) * (X @ X2.mT)

    def Kdiag(self, X):
        X = self._slice(X)
        if self.ard:
            return torch.sum(torch.square(X) * self.variances[..., None, :], dim=-1)
        return self.variances[..., None] * torch.sum(torch.square(X), dim=-1)

    def input_sensitivity(self, summarize=True):
        """Per-dimension variances (GPy linear.py:134)."""
        return self.variances.expand(self.input_dim)


@dataclasses.dataclass(frozen=True)
class LinearFull(Kernel):
    """K = X (W W^T + diag(kappa)) X2^T (GPy linear.py:183)."""

    W: torch.Tensor = None      # (D, rank)
    kappa: torch.Tensor = None  # (D,), positive

    @classmethod
    def create(cls, input_dim, rank, W=None, kappa=None, active_dims=None, dtype=None,
               device=None):
        where = placement(dtype, device)
        W = torch.ones(input_dim, rank, **where) if W is None else as_leaf(W, **where)
        kappa = torch.ones(input_dim, **where) if kappa is None else as_leaf(kappa, **where)
        assert W.shape == (input_dim, rank)
        assert kappa.shape == (input_dim,)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims), W=W, kappa=kappa)

    def _P(self):
        return self.W @ self.W.mT + torch.diag_embed(self.kappa)

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        return (X @ self._P()) @ X2.mT

    def Kdiag(self, X):
        X = self._slice(X)
        return torch.sum((X @ self._P()) * X, dim=-1)

    def input_sensitivity(self, summarize=True):
        return torch.diagonal(self._P(), dim1=-2, dim2=-1)

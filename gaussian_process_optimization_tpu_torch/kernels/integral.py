"""Integral kernels (twin of ``gaussian_process_optimization_tpu/kernels/integral.py``;
GPy integral.py:10, integral_limits.py:10,
multidimensional_integral_limits.py): a latent RBF rate f observed through
its integral.

- ``Integral``: K(X) is Cov[F(t), F(t')] of F(t) = int_0^t f, K(X, X2) is
  Cov[F(t), f(t')], Kdiag is k_ff's diagonal (the reference's API quirk, kept).
- ``IntegralLimits``: rows (t, s), observations int_s^t f.
- ``MultidimensionalIntegralLimits``: the product over (t_d, s_d) pairs.

Lanes: ``variances`` and a scalar ``lengthscale`` have shape ``lanes``; the
multidimensional ``lengthscale`` ``lanes + (D,)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import Kernel, as_leaf, dims_of, grid, placement

_SQPI = math.sqrt(math.pi)


def _g(z):
    """(integral.py:47-48)"""
    return z * _SQPI * torch.special.erf(z) + torch.exp(-(z ** 2))


def _kxx_limits(t, tp, s, sp, l):
    return 0.5 * l ** 2 * (_g((t - sp) / l) + _g((tp - s) / l) - _g((t - tp) / l)
                           - _g((s - sp) / l))


def _kxf_limits(t, tp, s, l):
    erf = torch.special.erf
    return 0.5 * _SQPI * l * (erf((t - tp) / l) + erf((tp - s) / l))


@dataclasses.dataclass(frozen=True)
class Integral(Kernel):
    variances: torch.Tensor = None
    lengthscale: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=1, variances=1.0, lengthscale=1.0, active_dims=None,
               dtype=None, device=None):
        assert input_dim == 1, "Integral kernel is 1-D (integral.py:15-25)"
        where = placement(dtype, device)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variances=as_leaf(variances, **where).reshape(()),
                   lengthscale=as_leaf(lengthscale, **where).reshape(()))

    def k_xx(self, t, tprime, l):
        """0.5 l^2 (g(t/l) - g((t - t')/l) + g(t'/l) - 1)."""
        return 0.5 * l ** 2 * (_g(t / l) - _g((t - tprime) / l) + _g(tprime / l) - 1.0)

    def k_xf(self, t, tprime, l):
        """0.5 sqrt(pi) l (erf((t - t')/l) + erf(t'/l))."""
        erf = torch.special.erf
        return 0.5 * _SQPI * l * (erf((t - tprime) / l) + erf(tprime / l))

    def k_ff(self, t, tprime, l=None):
        """exp(-(t - t')^2 / l^2), the latent function's covariance; ``l`` is
        the lengthscale unless given."""
        l = self.lengthscale if l is None else l
        return torch.exp(-torch.square(t - tprime) / torch.square(l))

    def K(self, X, X2=None):
        X = self._slice(X)
        t, l = X[..., :, None, 0], grid(self.lengthscale)
        if X2 is None:
            return grid(self.variances) * self.k_xx(t, X[..., None, :, 0], l)
        return grid(self.variances) * self.k_xf(t, self._slice(X2)[..., None, :, 0], l)

    def Kdiag(self, X):
        t = self._slice(X)[..., 0]
        return self.variances[..., None] * self.k_ff(t, t, self.lengthscale[..., None])


@dataclasses.dataclass(frozen=True)
class IntegralLimits(Kernel):
    """Observations over per-row windows [s, t] (integral_limits.py:10)."""

    variances: torch.Tensor = None
    lengthscale: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=2, variances=1.0, lengthscale=1.0, active_dims=None,
               dtype=None, device=None):
        assert input_dim == 2, "IntegralLimits takes (t, s) rows"
        where = placement(dtype, device)
        return cls(input_dim=2, active_dims=dims_of(active_dims),
                   variances=as_leaf(variances, **where).reshape(()),
                   lengthscale=as_leaf(lengthscale, **where).reshape(()))

    def K(self, X, X2=None):
        X = self._slice(X)
        t, s, l = X[..., :, None, 0], X[..., :, None, 1], grid(self.lengthscale)
        if X2 is None:
            return grid(self.variances) * _kxx_limits(t, X[..., None, :, 0], s,
                                                       X[..., None, :, 1], l)
        return grid(self.variances) * _kxf_limits(t, self._slice(X2)[..., None, :, 0], s, l)

    def Kdiag(self, X):
        return self.variances[..., None] * X.new_ones(X.shape[:-1])


@dataclasses.dataclass(frozen=True)
class MultidimensionalIntegralLimits(Kernel):
    """The product of per-dimension IntegralLimits factors, rows
    (t_1, s_1, t_2, s_2, ...), one lengthscale per dimension."""

    variances: torch.Tensor = None
    lengthscale: torch.Tensor = None  # (D,)

    @classmethod
    def create(cls, input_dim, variances=1.0, lengthscale=None, active_dims=None, dtype=None,
               device=None):
        assert input_dim % 2 == 0, "row layout is (t_d, s_d) pairs"
        where = placement(dtype, device)
        d = input_dim // 2
        ls = torch.ones(d, **where) if lengthscale is None else as_leaf(lengthscale, **where)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variances=as_leaf(variances, **where).reshape(()),
                   lengthscale=ls.reshape(-1).expand(d).clone())

    def K(self, X, X2=None):
        X = self._slice(X)
        Xc = X if X2 is None else self._slice(X2)
        out = None
        for q in range(self.lengthscale.shape[-1]):
            l = grid(self.lengthscale[..., q])
            t, s = X[..., :, None, 2 * q], X[..., :, None, 2 * q + 1]
            tp = Xc[..., None, :, 2 * q]
            if X2 is None:
                f = _kxx_limits(t, tp, s, X[..., None, :, 2 * q + 1], l)
            else:
                f = _kxf_limits(t, tp, s, l)
            out = f if out is None else out * f
        return grid(self.variances) * out

    def Kdiag(self, X):
        return self.variances[..., None] * X.new_ones(X.shape[:-1])

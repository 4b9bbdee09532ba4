"""TruncLinear, Hierarchical, Symmetric, the basis-function kernels and
IndependentOutputs (twin of ``gaussian_process_optimization_tpu/kernels/misc.py``;
GPy trunclinear.py:11, :110, independent_outputs.py:155, symmetric.py:6,
basis_funcs.py:10-220).

Lanes: ``variances`` and ``delta`` of the truncated-linear kernels are
``lanes + (1,)`` or ``lanes + (D,)``; a basis-function kernel's ``variance``
``lanes + (F,)`` (or ``(1,)``), its location leaves ``lanes + (F,)``;
``Symmetric.transform`` ``lanes + (D, D)`` (a trainable leaf, as in the
reference: its name is not a data name). ``K`` returns ``lanes + (N, M)``.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Kernel, as_leaf, dims_of, placement


def _dim(v, d):
    """Entry ``d`` of a ``lanes + (1,)`` or ``lanes + (D,)`` leaf, ``lanes + (1, 1)``."""
    return v[..., min(d, v.shape[-1] - 1), None, None]


def _dim_rows(v, d):
    return v[..., min(d, v.shape[-1] - 1), None]


def _pairs(X, X2, d):
    return X[..., :, None, d], X2[..., None, :, d]


@dataclasses.dataclass(frozen=True)
class TruncLinear(Kernel):
    """k(x, y) = sum_i var_i max(0, (x_i - delta_i)(y_i - delta_i))."""

    variances: torch.Tensor = None
    delta: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, variances=1.0, delta=0.0, ARD=False, active_dims=None,
               dtype=None, device=None):
        where = placement(dtype, device)
        shape = (input_dim,) if ARD else (1,)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variances=as_leaf(variances, **where).expand(shape).clone(),
                   delta=as_leaf(delta, **where).expand(shape).clone())

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        out = 0.0
        for d in range(X.shape[-1]):
            x, y = _pairs(X, X2, d)
            delta = _dim(self.delta, d)
            out = out + _dim(self.variances, d) * torch.clamp((x - delta) * (y - delta), min=0.0)
        return out

    def Kdiag(self, X):
        X = self._slice(X)
        return sum(_dim_rows(self.variances, d)
                   * torch.square(X[..., d] - _dim_rows(self.delta, d))
                   for d in range(X.shape[-1]))


@dataclasses.dataclass(frozen=True)
class TruncLinearInf(Kernel):
    """Shift-integrated truncated-linear kernel (trunclinear.py:110), per
    dimension |x - y|^3 / 6 + x y (b - a) - (x + y)(b^2 - a^2) / 2 + (b^3 - a^3) / 3
    over the interval (a, b), summed with per-dimension variances."""

    variances: torch.Tensor = None
    interval: tuple = (0.0, 1.0)

    @classmethod
    def create(cls, input_dim, interval, variances=1.0, ARD=False, active_dims=None,
               dtype=None, device=None):
        shape = (input_dim,) if ARD else (1,)
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   variances=as_leaf(variances, **placement(dtype, device)).expand(shape).clone(),
                   interval=(float(interval[0]), float(interval[1])))

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        a, b = self.interval
        out = 0.0
        for d in range(X.shape[-1]):
            x, y = _pairs(X, X2, d)
            diff = x - y
            term = (torch.abs(diff ** 3) / 6.0 + x * y * (b - a) - (x + y) * (b * b - a * a) / 2.0
                    + (b ** 3 - a ** 3) / 3.0)
            out = out + _dim(self.variances, d) * term
        return out

    def Kdiag(self, X):
        X = self._slice(X)
        a, b = self.interval
        tmp = torch.square(X) * (b - a) - X * (b * b - a * a) + (b ** 3 - a ** 3) / 3.0
        return sum(_dim_rows(self.variances, d) * tmp[..., d] for d in range(X.shape[-1]))


TruncLinear_inf = TruncLinearInf


@dataclasses.dataclass(frozen=True)
class Hierarchical(Kernel):
    """Hierarchical covariance (independent_outputs.py:155): ``parts[0]``
    everywhere, each further part only between rows that share the index in
    column ``base_dim + level``, as an equality-masked select."""

    parts: tuple = ()
    base_dim: int = 1

    @classmethod
    def create(cls, kernels):
        kernels = tuple(kernels)
        assert len(kernels) > 1, "need a base kernel plus >=1 level"
        assert all(k.input_dim == kernels[0].input_dim for k in kernels), (
            "Hierarchical needs equal input_dim across kernels "
            "(use active_dims for narrower levels)")
        base_dim = max(k.input_dim for k in kernels)
        return cls(input_dim=base_dim + len(kernels) - 1, parts=kernels, base_dim=base_dim)

    def K(self, X, X2=None):
        X2 = X if X2 is None else X2
        Xb, X2b = X[..., : self.base_dim], X2[..., : self.base_dim]
        out = self.parts[0].K(Xb, X2b)
        for lvl, kern in enumerate(self.parts[1:]):
            same = X[..., :, None, self.base_dim + lvl] == X2[..., None, :, self.base_dim + lvl]
            out = out + torch.where(same, kern.K(Xb, X2b), 0.0)
        return out

    def Kdiag(self, X):
        Xb = X[..., : self.base_dim]
        return sum(k.Kdiag(Xb) for k in self.parts)


@dataclasses.dataclass(frozen=True)
class Symmetric(Kernel):
    """Even or odd symmetry under the map x -> A x (symmetric.py:6):
    k(x, x') +- k(Ax, x') +- k(x, Ax') + k(Ax, Ax')."""

    base: Kernel = None
    transform: torch.Tensor = None  # (D, D)
    sign: float = 1.0               # +1 even, -1 odd

    @classmethod
    def create(cls, base_kernel, transform, symmetry_type="even"):
        sign = {"even": 1.0, "odd": -1.0}[symmetry_type]
        A = as_leaf(transform, like=base_kernel._leaf_like())
        return cls(input_dim=A.shape[0], base=base_kernel, transform=A, sign=sign)

    def K(self, X, X2=None):
        X2 = X if X2 is None else X2
        XA, X2A = X @ self.transform.mT, X2 @ self.transform.mT
        k = self.base.K
        return k(X, X2) + self.sign * k(XA, X2) + self.sign * k(X, X2A) + k(XA, X2A)

    def Kdiag(self, X):
        return self._pairwise_diag(X)


@dataclasses.dataclass(frozen=True)
class BasisFuncKernel(Kernel):
    """K = phi(X) diag(variance) phi(X2)^T (basis_funcs.py:10-100); subclasses
    define ``_phi``."""

    variance: torch.Tensor = None

    def _phi(self, X):
        raise NotImplementedError

    def phi(self, X):
        return self._phi(self._slice(X))

    def K(self, X, X2=None):
        p1 = self.phi(X)
        p2 = p1 if X2 is None else self.phi(X2)
        return (p1 * self.variance[..., None, :]) @ p2.mT

    def Kdiag(self, X):
        return torch.sum(self.variance[..., None, :] * torch.square(self.phi(X)), dim=-1)


def _vec(v, where):
    return as_leaf(v, **where).reshape(-1)


@dataclasses.dataclass(frozen=True)
class PolynomialBasisFuncKernel(BasisFuncKernel):
    """phi = [1, x, ..., x^degree] (basis_funcs.py:105-112)."""

    degree: int = 2

    @classmethod
    def create(cls, input_dim, degree, variance=1.0, ARD=True, active_dims=None, dtype=None,
               device=None):
        assert input_dim == 1, "basis-function kernels are 1-D (basis_funcs.py:18)"
        shape = (degree + 1,) if ARD else (1,)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **placement(dtype, device)).expand(shape).clone(),
                   degree=degree)

    def _phi(self, X):
        return torch.pow(X, torch.arange(self.degree + 1, dtype=X.dtype, device=X.device))


@dataclasses.dataclass(frozen=True)
class LinearSlopeBasisFuncKernel(BasisFuncKernel):
    """Linear between ``start`` and ``stop``, constant outside, centred
    (basis_funcs.py:126-146)."""

    start: torch.Tensor = None
    stop: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, start, stop, variance=1.0, ARD=False, active_dims=None,
               dtype=None, device=None):
        where = placement(dtype, device)
        start = _vec(start, where)
        shape = start.shape if ARD else (1,)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **where).expand(shape).clone(),
                   start=start, stop=_vec(stop, where))

    def _phi(self, X):
        start, stop = self.start[..., None, :], self.stop[..., None, :]
        return torch.minimum(torch.maximum(X, start), stop) - (stop + start) / 2.0


@dataclasses.dataclass(frozen=True)
class ChangePointBasisFuncKernel(BasisFuncKernel):
    """phi = -1 before the changepoint, 1 after (basis_funcs.py:148-161)."""

    changepoint: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, changepoint, variance=1.0, active_dims=None, dtype=None,
               device=None):
        where = placement(dtype, device)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variance=_vec(variance, where), changepoint=_vec(changepoint, where))

    def _phi(self, X):
        return torch.where(X < self.changepoint[..., None, :], -1.0, 1.0).to(X.dtype)


@dataclasses.dataclass(frozen=True)
class DomainKernel(BasisFuncKernel):
    """A constant plateau on (start, stop) (basis_funcs.py:163-175)."""

    start: torch.Tensor = None
    stop: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, start, stop, variance=1.0, active_dims=None, dtype=None,
               device=None):
        where = placement(dtype, device)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variance=_vec(variance, where), start=_vec(start, where),
                   stop=_vec(stop, where))

    def _phi(self, X):
        inside = (X > self.start[..., None, :]) & (X < self.stop[..., None, :])
        return inside.to(X.dtype)


@dataclasses.dataclass(frozen=True)
class LogisticBasisFuncKernel(BasisFuncKernel):
    """Logistic bumps at ``centers`` with trainable slopes
    (basis_funcs.py:177-220)."""

    centers: torch.Tensor = None
    slope: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, centers, variance=1.0, slope=1.0, ARD=False,
               active_dims=None, dtype=None, device=None):
        where = placement(dtype, device)
        centers = _vec(centers, where)
        shape = centers.shape if ARD else (1,)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **where).expand(shape).clone(), centers=centers,
                   slope=as_leaf(slope, **where).expand(centers.shape).clone())

    def _phi(self, X):
        z = (X - self.centers[..., None, :]) * self.slope[..., None, :]
        return 1.0 / (1.0 + torch.exp(-z))


def IndependentOutputs(kernels, output_dim=None):
    """Block-diagonal multi-output (GPy independent_outputs.py): each output
    its own kernel, or a copy of one; no cross-covariance. The output index
    is the last input column. Copies are distinct objects, since
    ``MultioutputKern`` gives one object on two outputs the full
    cross-covariance."""
    from .split import MultioutputKern

    if isinstance(kernels, (list, tuple)):
        ks = list(kernels)
    else:
        assert output_dim is not None, "pass output_dim when sharing one kernel"
        ks = [dataclasses.replace(kernels) for _ in range(output_dim)]
    return MultioutputKern.create(ks)

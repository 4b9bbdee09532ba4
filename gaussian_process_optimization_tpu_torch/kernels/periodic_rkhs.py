"""Periodic-subspace Matern RKHS kernels (twin of
``gaussian_process_optimization_tpu/kernels/periodic_rkhs.py``; GPy periodic.py:12,
:70, :171, :284).

Not the exp-sine kernel: the Matern RKHS projected on ``n_freq`` Fourier
harmonics of a period, K(x, x') = F(x) G^-1 F(x')^T, with G the basis's RKHS
Gram matrix on [lower, upper] in closed form. Phases from ``atan2``, the
w_i == w_j integral as a masked select, and a solve against G, as in the
reference.

Lanes: ``variance``, ``lengthscale`` and ``period`` have shape ``lanes``; the
basis, the Gram matrix and ``K`` carry them in front.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import Kernel, as_leaf, dims_of, placement

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _col(v):
    """A per-lane scalar as ``lanes + (1, 1)``."""
    return v[..., None, None]


def _cos_factorization(alpha, omega, phase):
    """Per-row sums of cosine terms sharing a frequency as one r cos(w x + psi)
    (periodic.py:44-50); rows are the basis functions, ``lanes + (2F, k)``."""
    r1 = torch.sum(alpha * torch.cos(phase), dim=-1, keepdim=True)
    r2 = torch.sum(alpha * torch.sin(phase), dim=-1, keepdim=True)
    r = torch.sqrt(r1 ** 2 + r2 ** 2)
    psi = torch.atan2(r2, r1)
    return r, omega[..., 0:1], psi


def _int_computation(lower, upper, r1, omega1, phi1, r2, omega2, phi2):
    """int_lower^upper r1 cos(w1 x + p1) r2 cos(w2 x + p2) dx over the outer
    pairing (periodic.py:52-57); the w1 == w2 limit is a masked select."""
    wsum = omega1 + omega2.mT
    wdiff = omega1 - omega2.mT
    psum = phi1 + phi2.mT
    pdiff = phi1 - phi2.mT
    term_sum = (torch.sin(wsum * upper + psum) - torch.sin(wsum * lower + psum)) / wsum
    same = torch.abs(wdiff) < 1e-10
    wdiff_safe = torch.where(same, torch.ones_like(wdiff), wdiff)
    term_diff = torch.where(
        same, torch.cos(pdiff) * (upper - lower),
        (torch.sin(wdiff * upper + pdiff) - torch.sin(wdiff * lower + pdiff)) / wdiff_safe)
    return (r1 @ r2.mT) / 2.0 * (term_sum + term_diff)


@dataclasses.dataclass(frozen=True)
class _PeriodicRKHS(Kernel):
    variance: torch.Tensor = None
    lengthscale: torch.Tensor = None
    period: torch.Tensor = None
    n_freq: int = 10
    lower: float = 0.0
    upper: float = 4.0 * math.pi

    @classmethod
    def create(cls, input_dim=1, variance=1.0, lengthscale=1.0, period=2.0 * math.pi,
               n_freq=10, lower=0.0, upper=4.0 * math.pi, active_dims=None, dtype=None,
               device=None):
        assert input_dim == 1, "periodic RKHS kernels are 1-D (periodic.py:27)"
        where = placement(dtype, device)
        return cls(input_dim=1, active_dims=dims_of(active_dims),
                   variance=as_leaf(variance, **where).reshape(()),
                   lengthscale=as_leaf(lengthscale, **where).reshape(()),
                   period=as_leaf(period, **where).reshape(()),
                   n_freq=n_freq, lower=float(lower), upper=float(upper))

    def _basis(self):
        """(alpha (2F,), omega ``lanes + (2F,)``, phi (2F,))."""
        like = self.period
        f = torch.arange(1, self.n_freq + 1, dtype=like.dtype, device=like.device)
        omega = torch.repeat_interleave(2.0 * math.pi * f / self.period[..., None], 2, dim=-1)
        phi = torch.tensor([-math.pi / 2.0, 0.0], dtype=like.dtype,
                           device=like.device).repeat(self.n_freq)
        return torch.ones_like(phi), omega, phi

    def _FX(self, x):
        """Basis at ``x (N, 1)``: ``lanes + (N, 2F)``."""
        alpha, omega, phi = self._basis()
        return alpha * torch.cos(omega[..., None, :] * x + phi)

    def _operator_columns(self, omega, phi):
        raise NotImplementedError

    def _gram(self):
        raise NotImplementedError

    def _gram_int(self):
        _, omega, phi = self._basis()
        La, Lo, Lp = self._operator_columns(omega, phi)
        r, w, p = _cos_factorization(La, Lo, Lp)
        return _int_computation(self.lower, self.upper, r, w, p, r, w, p)

    def _f_at_lower(self, order):
        """The basis's ``order``-th derivative at ``lower``, ``lanes + (2F, 1)``."""
        alpha, omega, phi = self._basis()
        a = alpha * omega ** order
        return (a * torch.cos(omega * self.lower + phi + order * math.pi / 2.0))[..., None]

    def K(self, X, X2=None):
        X = self._slice(X)
        FX = self._FX(X[..., 0:1])
        FX2 = FX if X2 is None else self._FX(self._slice(X2)[..., 0:1])
        return FX @ torch.linalg.solve(self._gram(), FX2.mT)

    def Kdiag(self, X):
        return self._pairwise_diag(X)


def _stack(cols, omega):
    return torch.stack([c.expand(omega.shape) for c in cols], dim=-1)


@dataclasses.dataclass(frozen=True)
class PeriodicExponential(_PeriodicRKHS):
    """Matern-1/2 (periodic.py:70-101): operator [1/l, 1],
    G = l / (2 s2) Gint + F(lower) F(lower)^T / s2."""

    def _operator_columns(self, omega, phi):
        La = _stack([(1.0 / self.lengthscale)[..., None], omega], omega)
        Lo = _stack([omega, omega], omega)
        Lp = _stack([phi, phi + math.pi / 2.0], omega)
        return La, Lo, Lp

    def _gram(self):
        Fl = self._f_at_lower(0)
        return (_col(self.lengthscale / (2.0 * self.variance)) * self._gram_int()
                + (Fl @ Fl.mT) / _col(self.variance))


@dataclasses.dataclass(frozen=True)
class PeriodicMatern32(_PeriodicRKHS):
    """Matern-3/2 (periodic.py:171-209): operator [3/l^2, 2 sqrt(3)/l, 1]."""

    def _operator_columns(self, omega, phi):
        l = self.lengthscale[..., None]
        La = _stack([3.0 / l ** 2, (2.0 * _SQRT3 / l) * omega, omega ** 2], omega)
        Lo = _stack([omega, omega, omega], omega)
        Lp = _stack([phi, phi + math.pi / 2.0, phi + math.pi], omega)
        return La, Lo, Lp

    def _gram(self):
        Fl, F1l = self._f_at_lower(0), self._f_at_lower(1)
        v, l = _col(self.variance), _col(self.lengthscale)
        return (l ** 3 / (12.0 * _SQRT3 * v) * self._gram_int() + (Fl @ Fl.mT) / v
                + l ** 2 / (3.0 * v) * (F1l @ F1l.mT))


@dataclasses.dataclass(frozen=True)
class PeriodicMatern52(_PeriodicRKHS):
    """Matern-5/2 (periodic.py:284-330): operator
    [5 sqrt(5)/l^3, 15/l^2, 3 sqrt(5)/l, 1] and its boundary terms."""

    def _operator_columns(self, omega, phi):
        l = self.lengthscale[..., None]
        La = _stack([5.0 * _SQRT5 / l ** 3, (15.0 / l ** 2) * omega,
                     (3.0 * _SQRT5 / l) * omega ** 2, omega ** 3], omega)
        Lo = _stack([omega] * 4, omega)
        Lp = _stack([phi, phi + math.pi / 2.0, phi + math.pi, phi + 3.0 * math.pi / 2.0], omega)
        return La, Lo, Lp

    def _gram(self):
        Fl, F1l, F2l = self._f_at_lower(0), self._f_at_lower(1), self._f_at_lower(2)
        v, l = _col(self.variance), _col(self.lengthscale)
        l2 = l ** 2
        lower_terms = ((9.0 / 8.0) * (Fl @ Fl.mT) + (9.0 * l2 ** 2 / 200.0) * (F2l @ F2l.mT)
                       + (3.0 * l2 / 5.0) * (F1l @ F1l.mT) + (3.0 * l2 / 40.0) * (F2l @ Fl.mT)
                       + (3.0 * l2 / 40.0) * (Fl @ F2l.mT))
        return 3.0 * l ** 5 / (400.0 * _SQRT5 * v) * self._gram_int() + lower_terms / v

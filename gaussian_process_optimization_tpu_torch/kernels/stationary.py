"""Stationary kernels: K = K_of_r(scaled distance) (twin of
``gaussian_process_optimization_tpu/kernels/stationary.py``, GPy stationary.py).

The plain path builds the squared distance with the -2 X X2^T + |X|^2 + |X2|^2
matmul (GPy stationary.py:155-173); float32 matmuls run in full precision
(``config.py`` turns TF32 off). Calls that pass the kernel gate
(``ops/cuda_kernels.supports``) go to the CUDA K build instead, which uses
explicit per-dimension differences.

Lanes: ``variance`` of shape ``()`` or ``(B,)``; ``lengthscale`` of shape
``lanes + (D,)`` (ARD) or ``lanes`` (isotropic).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..config import resolve_device, resolve_dtype
from ..ops import cuda_kernels
from ..utils.profiling import spanned
from .base import Kernel


def sq_dist(X, X2=None):
    """Pairwise squared distance clipped at 0 (GPy _unscaled_dist:155)."""
    if X2 is None:
        Xsq = torch.sum(torch.square(X), dim=-1)
        r2 = -2.0 * (X @ X.transpose(-1, -2)) + Xsq[..., :, None] + Xsq[..., None, :]
        r2 = torch.clamp(r2, min=0.0)
        n = X.shape[-2]
        # exact zeros on the diagonal (GPy sets them explicitly)
        return r2 * (1.0 - torch.eye(n, dtype=X.dtype, device=X.device))
    X1sq = torch.sum(torch.square(X), dim=-1)
    X2sq = torch.sum(torch.square(X2), dim=-1)
    r2 = -2.0 * (X @ X2.transpose(-1, -2)) + X1sq[..., :, None] + X2sq[..., None, :]
    # value == max(r2, 0); the gradient passes through unchanged
    return r2 - torch.clamp(r2, max=0.0).detach()


def safe_sqrt(r2):
    """sqrt with a zero (not NaN) gradient at r2 == 0."""
    zero = r2 == 0.0
    safe = torch.where(zero, torch.ones_like(r2), r2)
    return torch.where(zero, torch.zeros_like(r2), torch.sqrt(safe))


def _as_tensor(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Stationary(Kernel):
    variance: torch.Tensor = None
    lengthscale: torch.Tensor = None

    _family = None
    K_of_r2 = None  # subclasses smooth in r^2 override (skips the sqrt)

    @classmethod
    def create(cls, input_dim, variance=1.0, lengthscale=None, ARD=False,
               active_dims=None, dtype=None, device=None, **extra):
        """GPy-style constructor (stationary.py:61-83); ``device`` None means
        the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        if lengthscale is None:
            lengthscale = torch.ones((input_dim,) if ARD else (), dtype=dtype, device=device)
        else:
            lengthscale = _as_tensor(lengthscale, dtype, device)
            lengthscale = (lengthscale.expand(input_dim).clone() if ARD
                           else lengthscale.reshape(()))
        return cls(input_dim=input_dim,
                   active_dims=tuple(active_dims) if active_dims is not None else None,
                   variance=_as_tensor(variance, dtype, device).reshape(()),
                   lengthscale=lengthscale,
                   **{k: _as_tensor(v, dtype, device).reshape(()) for k, v in extra.items()})

    @property
    def is_ard(self) -> bool:
        return (self.lengthscale.ndim > self.variance.ndim
                and self.lengthscale.shape[-1] > 1)

    def _lane(self, v):
        """Per-lane scalar reshaped to broadcast against (..., N, M)."""
        return v.reshape(tuple(self.variance.shape) + (1, 1))

    def K_of_r(self, r):
        raise NotImplementedError

    def dK_dr(self, r):
        """d K_of_r / dr elementwise, by autograd (the families below that the
        reference gives a closed form override it)."""
        with torch.enable_grad():
            r = r.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.K_of_r(r).sum(), r)
        return g

    def input_sensitivity(self, summarize=True):
        """variance / lengthscale^2 per dimension (GPy stationary.py:270)."""
        return (self.variance / torch.square(self.lengthscale)).expand(self.input_dim)

    def curvature0(self):
        """-2 d(K_of_r2)/d(r2) at r2 == 0 (r2 in lengthscale-scaled units): the
        diagonal curvature d2k/dx_a dx'_a at coincident points is
        curvature0 / lengthscale_a^2. Differentiated from ``K_of_r2`` where the
        kernel has one; the sqrt families give the analytic constant;
        Exponential and OU are not twice differentiable at r = 0 and raise."""
        if self.K_of_r2 is not None:
            with torch.enable_grad():
                u0 = torch.zeros_like(self.variance).requires_grad_(True)
                (g,) = torch.autograd.grad(self.K_of_r2(u0).sum(), u0)
            return -2.0 * g
        raise NotImplementedError(
            f"{type(self).__name__} has no diagonal curvature "
            "(not C^2 at r=0, or curvature0 not implemented)")

    def d2K_dXdX2_diag(self, x):
        """Analytic prior curvature at the diagonal: curvature0 / l_a^2 on the
        kernel's active dimensions, 0 elsewhere (nested differentiation through
        the guarded sqrt returns 0 for the sqrt families)."""
        vec = (self.curvature0() / torch.square(self.lengthscale)).expand(self.input_dim)
        D = x.shape[-1]
        idx = list(self.active_dims if self.active_dims is not None
                   else range(self.input_dim))
        out = torch.zeros(D, D, dtype=vec.dtype, device=vec.device)
        out[idx, idx] = vec
        return out

    def _scaled_dist(self, X, X2=None):
        """r scaled by lengthscale; ARD divides per dimension first."""
        if self.is_ard:
            ls = self.lengthscale[..., None, :]
            return safe_sqrt(sq_dist(X / ls, None if X2 is None else X2 / ls))
        return safe_sqrt(sq_dist(X, X2)) / self._lane(self.lengthscale)

    def _scaled_dist2(self, X, X2=None):
        if self.is_ard:
            ls = self.lengthscale[..., None, :]
            return sq_dist(X / ls, None if X2 is None else X2 / ls)
        return sq_dist(X, X2) / torch.square(self._lane(self.lengthscale))

    @spanned("kern.K")
    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = self._slice(X2)
        if cuda_kernels.supports(self, X, X2):
            return cuda_kernels.stationary_K(self, X, X2)
        if self.K_of_r2 is not None:
            return self.K_of_r2(self._scaled_dist2(X, X2))
        return self.K_of_r(self._scaled_dist(X, X2))

    def Kdiag(self, X):
        X = self._slice(X)
        ones = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
        return ones * self.variance[..., None]


@dataclasses.dataclass(frozen=True)
class RBF(Stationary):
    """sigma^2 exp(-r^2/2) (GPy rbf.py:51)."""

    _family = "rbf"

    def K_of_r(self, r):
        return self._lane(self.variance) * torch.exp(-0.5 * torch.square(r))

    def K_of_r2(self, r2):
        return self._lane(self.variance) * torch.exp(-0.5 * r2)

    def dK_dr(self, r):
        return -r * self.K_of_r(r)


ExpQuad = RBF


@dataclasses.dataclass(frozen=True)
class Exponential(Stationary):
    """sigma^2 exp(-r) (GPy stationary.py:384)."""

    _family = "exponential"

    def K_of_r(self, r):
        return self._lane(self.variance) * torch.exp(-r)

    def dK_dr(self, r):
        return -self.K_of_r(r)


@dataclasses.dataclass(frozen=True)
class OU(Stationary):
    """Ornstein-Uhlenbeck / Matern-1/2 (GPy stationary.py:427)."""

    _family = "ou"

    def K_of_r(self, r):
        return self._lane(self.variance) * torch.exp(-r)


@dataclasses.dataclass(frozen=True)
class Matern32(Stationary):
    """sigma^2 (1 + sqrt(3) r) exp(-sqrt(3) r) (GPy stationary.py:447)."""

    _family = "matern32"

    def K_of_r(self, r):
        s3r = math.sqrt(3.0) * r
        return self._lane(self.variance) * (1.0 + s3r) * torch.exp(-s3r)

    def dK_dr(self, r):
        return -3.0 * self._lane(self.variance) * r * torch.exp(-math.sqrt(3.0) * r)

    def curvature0(self):
        # k(u) = v (1 + sqrt(3u)) exp(-sqrt(3u)) = v (1 - (3/2) u + O(u^{3/2}))
        return 3.0 * self.variance


@dataclasses.dataclass(frozen=True)
class Matern52(Stationary):
    """sigma^2 (1 + sqrt(5) r + 5/3 r^2) exp(-sqrt(5) r) (GPy stationary.py:575)."""

    _family = "matern52"

    def K_of_r(self, r):
        s5r = math.sqrt(5.0) * r
        return (self._lane(self.variance) * (1.0 + s5r + 5.0 / 3.0 * torch.square(r))
                * torch.exp(-s5r))

    def curvature0(self):
        # k(u) = v (1 + sqrt(5u) + 5u/3) exp(-sqrt(5u)) = v (1 - (5/6) u + O(u^{3/2}))
        return 5.0 / 3.0 * self.variance


@dataclasses.dataclass(frozen=True)
class Cosine(Stationary):
    """sigma^2 cos(r) (GPy stationary.py:654)."""

    _family = "cosine"

    def K_of_r(self, r):
        return self._lane(self.variance) * torch.cos(r)

    def curvature0(self):
        # k(u) = v cos(sqrt(u)) = v (1 - u/2 + O(u^2))
        return self.variance


@dataclasses.dataclass(frozen=True)
class Sinc(Stationary):
    """sigma^2 sin(2r) / (2r), a band-limited kernel (GPy stationary.py Sinc).
    It is not one of the CUDA kernels' seven families, so it always takes the
    plain path."""

    _family = "sinc"

    def K_of_r(self, r):
        return self._lane(self.variance) * torch.sinc(2.0 * r / math.pi)

    def curvature0(self):
        # k(u) = v sin(2 sqrt(u)) / (2 sqrt(u)) = v (1 - (2/3) u + O(u^2))
        return 4.0 / 3.0 * self.variance


@dataclasses.dataclass(frozen=True)
class RatQuad(Stationary):
    """sigma^2 (1 + r^2/2)^-power (GPy stationary.py:665)."""

    power: torch.Tensor = None
    _family = "ratquad"

    @classmethod
    def create(cls, input_dim, variance=1.0, lengthscale=None, power=2.0, ARD=False,
               active_dims=None, dtype=None, device=None):
        return super().create(input_dim, variance, lengthscale, ARD, active_dims,
                              dtype=dtype, device=device, power=power)

    def K_of_r(self, r):
        return self.K_of_r2(torch.square(r))

    def K_of_r2(self, r2):
        return self._lane(self.variance) * torch.exp(
            -self._lane(self.power) * torch.log1p(r2 / 2.0))


FAMILY_CLASSES = {"rbf": RBF, "exponential": Exponential, "ou": OU,
                  "matern32": Matern32, "matern52": Matern52, "cosine": Cosine,
                  "ratquad": RatQuad, "sinc": Sinc}

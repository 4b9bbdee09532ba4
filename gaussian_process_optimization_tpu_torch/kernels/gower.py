"""Gower mixed-variable product kernel (twin of
``gaussian_process_optimization_tpu/kernels/gower.py``; the reference author's
GPy stationary.py:108-140).

K = prod_d K_of_r(r_d) over the input dimensions, continuous ones first:
r_d = |x_d - x'_d| / range_d on a continuous dimension (the design space's
value range), r_d = 1[x_d != x'_d] on a discrete one.

``gpy_compat=True`` keeps the reference's quirks: each factor carries the
base's variance, so K carries variance^D; the base's lengthscale is ignored
(its gradient is exactly zero, but it stays a leaf, so the packed vector's
order matches the JAX packer); ``Kdiag`` returns the variance, not
variance^D. The corrected mode multiplies unit-variance factors of
r_d / lengthscale_d by one variance.

Lanes: the base's hyperparameters may carry a leading lane axis; ``K`` then
returns ``(B, N, M)`` (the r_d are shared by all lanes). The symmetric build
under autograd is rematerialized (``torch.utils.checkpoint``), as the reference
does with ``jax.checkpoint``: the product keeps several ``(B, N, N)`` buffers
per dimension otherwise, 335 MB each at N=4096 and B=5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .base import Kernel
from .stationary import Stationary


@dataclasses.dataclass(frozen=True)
class Gower(Kernel):
    base: Stationary = None  # supplies K_of_r, variance, lengthscale
    ranges: torch.Tensor = None  # (n_continuous,) value ranges of the continuous dims
    cont_dims: tuple = ()
    disc_dims: tuple = ()
    gpy_compat: bool = False

    @classmethod
    def create(cls, base: Stationary, ranges, cont_dims, disc_dims, gpy_compat=False):
        v = base.variance
        return cls(input_dim=base.input_dim, active_dims=base.active_dims, base=base,
                   ranges=torch.as_tensor(np.asarray(ranges, dtype=float), dtype=v.dtype,
                                          device=v.device),
                   cont_dims=tuple(cont_dims), disc_dims=tuple(disc_dims),
                   gpy_compat=bool(gpy_compat))

    def _ls(self, d):
        ls = self.base.lengthscale
        return ls[..., d] if self.base.is_ard else ls

    def _build(self, X, X2):
        base = self.base
        unit = base if self.gpy_compat else dataclasses.replace(
            base, variance=torch.ones_like(base.variance))
        cont_index = {d: i for i, d in enumerate(sorted(self.cont_dims))}
        out = None
        for d in sorted(self.cont_dims) + sorted(self.disc_dims):
            if d in cont_index:
                r = torch.abs(X[:, None, d] - X2[None, :, d]) / self.ranges[cont_index[d]]
            else:
                r = (X[:, None, d] != X2[None, :, d]).to(X.dtype)
            if not self.gpy_compat:
                r = r / base._lane(self._ls(d))
            k = unit.K_of_r(r)
            out = k if out is None else out * k
        if not self.gpy_compat:
            out = base._lane(base.variance) * out
        return out

    def K(self, X, X2=None):
        X = self._slice(X)
        if X2 is None and torch.is_grad_enabled():
            return checkpoint(self._build, X, X, use_reentrant=False)
        return self._build(X, X if X2 is None else self._slice(X2))

    def Kdiag(self, X):
        X = self._slice(X)
        ones = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
        return ones * self.base.variance[..., None]

"""Kronecker (grid) GP regression (twin of
``gaussian_process_optimization_tpu/models/gp_grid.py``; GPy
models/gp_grid_regression.py, core/gp_grid.py, gaussian_grid_inference.py).

Inputs on a Cartesian grid X_1 x ... x X_D under a product kernel give
K = K_1 (x) ... (x) K_D; one ``eigh`` per axis (eigenvalues clamped at 0)
gives exact inference in O(sum n_i^3), and the Kronecker matrix-vector
product applies one factor per axis, so no full Gram matrix is formed.
Gradients go through ``eigh``.

Lanes: the kernels' leaves and ``likelihood_variance`` may carry a leading
lane axis (the fitter's restarts); the -LML is then one value per lane.
``predict`` takes one set of hyperparameters. The grid coordinates ``axes``
are a trainable leaf, as in the reference (their name is not a data name);
``workload.grid_fit`` fixes them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config
from ..kernels.base import placement

LOG_2_PI = math.log(2.0 * math.pi)


def _kron_mv(mats, y):
    """(A_1 (x) ... (x) A_D) vec(y), one factor along each of y's last D
    axes; a factor's leading lane axes broadcast against y's."""
    D = len(mats)
    out = y
    for axis, A in enumerate(mats):
        ax = axis - D
        out = torch.movedim(out, ax, -1)
        Ab = A.reshape(A.shape[:-2] + (1,) * (D - 1) + A.shape[-2:])
        out = torch.movedim((Ab @ out[..., None])[..., 0], -1, ax)
    return out


@dataclasses.dataclass(frozen=True)
class GPGridRegression:
    kerns: tuple = ()                       # one kernel per grid axis
    likelihood_variance: torch.Tensor = None
    axes: tuple = ()                        # per-axis inputs (n_i, d_i)
    Y: torch.Tensor = None                  # (n_1, ..., n_D)

    @classmethod
    def create(cls, axes, Y, kernels, noise_var=0.1, dtype=None, device=None):
        """``device`` None means the card."""
        where = placement(dtype, device)
        axes = tuple(torch.as_tensor(np.asarray(a, dtype=float).reshape(len(a), -1), **where)
                     for a in axes)
        shape = tuple(a.shape[0] for a in axes)
        return cls(kerns=tuple(kernels),
                   likelihood_variance=torch.as_tensor(float(noise_var), **where).reshape(()),
                   axes=axes,
                   Y=torch.as_tensor(np.asarray(Y, dtype=float), **where).reshape(shape))

    def _eigs(self):
        Qs, lams = [], []
        for k, a in zip(self.kerns, self.axes):
            lam, Q = torch.linalg.eigh(k.K(a))
            Qs.append(Q)
            lams.append(torch.clamp(lam, min=0.0))
        return Qs, lams

    @staticmethod
    def _lam_kron(lams):
        lam = lams[0]
        for l in lams[1:]:
            lam = (lam[..., :, None] * l[..., None, :]).flatten(-2)
        return lam

    def _noisy_lam(self, lams):
        return self._lam_kron(lams) + (self.likelihood_variance + config.noise_jitter)[..., None]

    def log_marginal_likelihood(self):
        Qs, lams = self._eigs()
        lam = self._noisy_lam(lams)
        Qt_y = _kron_mv([Q.mT for Q in Qs], self.Y).flatten(-self.Y.ndim)
        n = Qt_y.shape[-1]
        quad = torch.sum(torch.square(Qt_y) / lam, dim=-1)
        return -0.5 * (n * LOG_2_PI + torch.sum(torch.log(lam), dim=-1) + quad)

    def _alpha(self, Qs, lam):
        Qt_y = _kron_mv([Q.mT for Q in Qs], self.Y).reshape(-1)
        return _kron_mv(Qs, (Qt_y / lam).reshape(self.Y.shape))  # (K + s2 I)^-1 y

    def predict(self, Xnew, include_likelihood=True):
        """Mean and variance at arbitrary points ``Xnew (n, sum d_i)``: each
        point's cross-covariance is the Kronecker product of its per-axis
        ones."""
        Qs, lams = self._eigs()
        lam = self._noisy_lam(lams)
        alpha = self._alpha(Qs, lam)
        Xnew = torch.as_tensor(np.atleast_2d(np.asarray(Xnew, dtype=float)),
                               dtype=self.Y.dtype, device=self.Y.device)
        parts = torch.split(Xnew, [a.shape[1] for a in self.axes], dim=1)
        ks = [k.K(a, xp) for k, a, xp in zip(self.kerns, self.axes, parts)]  # (n_i, M)
        # contract k_1 (x) ... (x) k_D against alpha, one point per column
        mu = torch.tensordot(ks[0], alpha, dims=([0], [0]))  # (M, n_2, ..., n_D)
        for kv in ks[1:]:
            mu = torch.einsum("mi...,im->m...", mu, kv)
        v = None
        for Q, kv in zip(Qs, ks):
            vp = Q.mT @ kv  # (n_i, M)
            v = vp if v is None else (v[:, None, :] * vp[None, :, :]).reshape(-1, vp.shape[-1])
        kss = 1.0
        for k, xp in zip(self.kerns, parts):
            kss = kss * k.Kdiag(xp)
        var = torch.clamp(kss - torch.sum(torch.square(v) / lam[:, None], dim=0), min=1e-15)
        if include_likelihood:
            var = var + self.likelihood_variance
        return mu[:, None], var[:, None]

"""ODE-derived multi-output kernels (twin of
``gaussian_process_optimization_tpu/kernels/ode.py``; GPy ODE_UY.py:10,
ODE_UYC.py:12, ODE_t.py:11, ODE_st.py:10).

Inputs are (time..., output index), the index in the last column; the
outputs are tied by a linear ODE operator and each block is a closed form,
assembled by one masked select over the index column.

- ``ODE_UY``: index 0 = U (Matern-3/2 force), 1 = Y (its first-order filter).
- ``ODE_UYC``: ``ODE_UY`` plus ``ubias`` on the U-U block only.
- ``ODE_t``: index 0 = Y (RBF), 1 = U = Y + dY/dt; ``a`` and ``c`` are leaves
  that K never reads, as in the reference.
- ``ODE_st``: inputs (t, x, index), U = -a d2Y/dx2 + b dY/dt + c Y over a
  separable RBF Y.

Lanes: every leaf has shape ``lanes``. ``variance_U`` and ``lengthscale_U``
are unconstrained leaves: the packing keys on the last attribute name, and
neither is a positive name (the reference's behaviour, kept for parity).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .base import Kernel, as_leaf, dims_of, grid, placement

_SQRT3 = math.sqrt(3.0)


def _index_masks(X, X2):
    m1 = X[..., :, None, -1]
    m2 = (X if X2 is None else X2)[..., None, :, -1]
    lo1, lo2 = m1 < 0.5, m2 < 0.5
    return lo1 & lo2, lo1 & ~lo2, ~lo1 & lo2, ~lo1 & ~lo2


def _times(X, X2, col=0):
    return X[..., :, None, col], (X if X2 is None else X2)[..., None, :, col]


def _scalars(where, **values):
    return {k: as_leaf(v, **where).reshape(()) for k, v in values.items()}


def _select(masks, blocks):
    return sum(torch.where(m, b, 0.0) for m, b in zip(masks, blocks))


@dataclasses.dataclass(frozen=True)
class ODE_UY(Kernel):
    variance_U: torch.Tensor = None
    variance_Y: torch.Tensor = None
    lengthscale_U: torch.Tensor = None
    lengthscale_Y: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=2, variance_U=3.0, variance_Y=1.0, lengthscale_U=1.0,
               lengthscale_Y=1.0, active_dims=None, dtype=None, device=None):
        if input_dim != 2:
            raise ValueError("ODE_UY is defined for input_dim=2 (time, index)")
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   **_scalars(placement(dtype, device), variance_U=variance_U,
                              variance_Y=variance_Y, lengthscale_U=lengthscale_U,
                              lengthscale_Y=lengthscale_Y))

    def _rates(self):
        return grid(_SQRT3 / self.lengthscale_U), grid(1.0 / self.lengthscale_Y)

    def _kuu(self, adist):
        lu, _ = self._rates()
        return grid(self.variance_U) * (1 + lu * adist) * torch.exp(-lu * adist)

    def _kyy(self, adist):
        lu, ly = self._rates()
        k1 = torch.exp(-ly * adist) * (2 * lu + ly) / (lu + ly) ** 2
        k2 = (torch.exp(-lu * adist) * (ly - 2 * lu + lu * ly * adist - lu ** 2 * adist)
              + torch.exp(-ly * adist) * (2 * lu - ly)) / (ly - lu) ** 2
        k3 = torch.exp(-lu * adist) * ((1 + lu * adist) / (lu + ly) + lu / (lu + ly) ** 2)
        return grid(self.variance_U * self.variance_Y) * (k1 + k2 + k3)

    def _kuy(self, rdist):
        """Cov(U(t_u), Y(t_y)), rdist = t_u - t_y (ODE_UY.py:59-77). Each
        branch's argument is clamped to its own half-line, so neither exp
        overflows where the select discards it."""
        lu, ly = self._rates()
        vyu = grid(torch.sqrt(self.variance_Y * 2.0 / self.lengthscale_Y))
        dp = torch.clamp(rdist, min=0.0)
        dn = torch.clamp(rdist, max=0.0)
        kyu3 = torch.exp(-lu * dp) / (lu + ly) * (1 + lu * (dp + 1 / (lu + ly)))
        e = torch.exp((lu - ly) * dn)
        k1c = torch.exp(ly * dn) / (lu - ly) * (1 - e + lu * (dn * e + (1 - e) / (lu - ly)))
        k2c = torch.exp(ly * dn) * (1 / (lu + ly) + lu / (lu + ly) ** 2)
        vu = grid(self.variance_U)
        return torch.where(rdist > 0, vu * vyu * kyu3, vu * vyu * (k1c + k2c))

    def K(self, X, X2=None):
        t1, t2 = _times(X, X2)
        rdist = t1 - t2
        adist = torch.abs(rdist)
        # Cov(Y(t_y), U(t_u)) = _kuy(t_u - t_y) = _kuy(-rdist)
        return _select(_index_masks(X, X2),
                       (self._kuu(adist), self._kuy(rdist), self._kuy(-rdist), self._kyy(adist)))

    def Kdiag(self, X):
        lu, ly = _SQRT3 / self.lengthscale_U, 1.0 / self.lengthscale_Y
        k1 = (2 * lu + ly) / (lu + ly) ** 2
        k3 = 1 / (lu + ly) + lu / (lu + ly) ** 2
        yvar = (self.variance_U * self.variance_Y * (k1 + k3))[..., None]  # k2(0) = 0
        return torch.where(X[..., -1] >= 0.5, yvar, self.variance_U[..., None])


@dataclasses.dataclass(frozen=True)
class ODE_UYC(ODE_UY):
    ubias: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=2, variance_U=3.0, variance_Y=1.0, lengthscale_U=1.0,
               lengthscale_Y=1.0, ubias=1.0, active_dims=None, dtype=None, device=None):
        base = ODE_UY.create(input_dim, variance_U, variance_Y, lengthscale_U, lengthscale_Y,
                             active_dims, dtype=dtype, device=device)
        return cls(input_dim=base.input_dim, active_dims=base.active_dims,
                   variance_U=base.variance_U, variance_Y=base.variance_Y,
                   lengthscale_U=base.lengthscale_U, lengthscale_Y=base.lengthscale_Y,
                   ubias=as_leaf(ubias, like=base.variance_U).reshape(()))

    def _kuu(self, adist):
        return super()._kuu(adist) + grid(self.ubias)

    def Kdiag(self, X):
        return super().Kdiag(X) + torch.where(X[..., -1] < 0.5, self.ubias[..., None], 0.0)


@dataclasses.dataclass(frozen=True)
class ODE_t(Kernel):
    a: torch.Tensor = None
    c: torch.Tensor = None
    variance_Yt: torch.Tensor = None
    lengthscale_Yt: torch.Tensor = None
    ubias: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=2, a=1.0, c=1.0, variance_Yt=3.0, lengthscale_Yt=1.5, ubias=1.0,
               active_dims=None, dtype=None, device=None):
        if input_dim != 2:
            raise ValueError("ODE_t is defined for input_dim=2 (time, index)")
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   **_scalars(placement(dtype, device), a=a, c=c, variance_Yt=variance_Yt,
                              lengthscale_Yt=lengthscale_Yt, ubias=ubias))

    def K(self, X, X2=None):
        t1, t2 = _times(X, X2)
        td = t1 - t2
        td2 = td * td
        lyt = grid(1.0 / (2.0 * self.lengthscale_Yt))
        base = grid(self.variance_Yt) * torch.exp(-lyt * td2)
        k_uu = (1 + 2 * lyt - 4 * lyt ** 2 * td2) * base + grid(self.ubias)
        # here index 0 = Y
        return _select(_index_masks(X, X2), (base, (1 + 2 * lyt * td) * base,
                                             (1 - 2 * lyt * td) * base, k_uu))

    def Kdiag(self, X):
        lyt = 1.0 / (2.0 * self.lengthscale_Yt)
        v = self.variance_Yt
        u = (2 * lyt * v + v + self.ubias)[..., None]
        return torch.where(X[..., -1] >= 0.5, u, v[..., None] * X.new_ones(X.shape[:-1]))


@dataclasses.dataclass(frozen=True)
class ODE_st(Kernel):
    a: torch.Tensor = None
    b: torch.Tensor = None
    c: torch.Tensor = None
    variance_Yt: torch.Tensor = None
    variance_Yx: torch.Tensor = None
    lengthscale_Yt: torch.Tensor = None
    lengthscale_Yx: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=3, a=1.0, b=1.0, c=1.0, variance_Yx=3.0, variance_Yt=1.5,
               lengthscale_Yx=1.5, lengthscale_Yt=1.5, active_dims=None, dtype=None,
               device=None):
        if input_dim != 3:
            raise ValueError("ODE_st is defined for input_dim=3 (t, x, index)")
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims),
                   **_scalars(placement(dtype, device), a=a, b=b, c=c, variance_Yt=variance_Yt,
                              variance_Yx=variance_Yx, lengthscale_Yt=lengthscale_Yt,
                              lengthscale_Yx=lengthscale_Yx))

    def K(self, X, X2=None):
        t1, t2 = _times(X, X2, 0)
        x1, x2 = _times(X, X2, 1)
        td, xd = t1 - t2, x1 - x2
        td2, xd2 = td * td, xd * xd
        lyt = grid(1.0 / (2.0 * self.lengthscale_Yt))
        lyx = grid(1.0 / (2.0 * self.lengthscale_Yx))
        a, b, c = grid(self.a), grid(self.b), grid(self.c)
        base = grid(self.variance_Yt * self.variance_Yx) * torch.exp(-lyt * td2 - lyx * xd2)
        k1 = 2 * lyt - 4 * lyt ** 2 * td2
        k2 = 4 * lyx ** 2 * xd2 - 2 * lyx
        k3 = 12 * lyx ** 2 - 48 * xd2 * lyx ** 3 + 16 * xd2 ** 2 * lyx ** 4
        k4 = 2 * lyt * td
        return _select(_index_masks(X, X2), (
            base, (-a * k2 + b * k4 + c) * base, (-a * k2 - b * k4 + c) * base,
            (b ** 2 * k1 - 2 * a * c * k2 + a ** 2 * k3 + c ** 2) * base))

    def Kdiag(self, X):
        lyt = 1.0 / (2.0 * self.lengthscale_Yt)
        lyx = 1.0 / (2.0 * self.lengthscale_Yx)
        a, b, c = self.a, self.b, self.c
        v = self.variance_Yt * self.variance_Yx
        u = ((b ** 2 * (2 * lyt) + 2 * a * c * (2 * lyx) + a ** 2 * (12 * lyx ** 2) + c ** 2)
             * v)[..., None]
        return torch.where(X[..., -1] >= 0.5, u, v[..., None] * X.new_ones(X.shape[:-1]))

"""Latent force model kernels (twin of ``gaussian_process_optimization_tpu/kernels/lfm.py``;
GPy eq_ode1.py:11, eq_ode2.py; Lawrence, Sanguinetti & Rattray 2007, Alvarez,
Luengo & Lawrence 2009).

EQ_ODE1: dy_j/dt + d_j y_j = sum_r w_jr u_r(t), u_r ~ GP(0, exp(-(t - t')^2 / l_r^2)).
EQ_ODE2: d2y_j/dt2 + C_j dy_j/dt + B_j y_j = sum_r w_jr u_r(t); its Green's
function splits into two first-order responses at the complex decays
gamma = alpha -+ i omega (alpha = C/2, omega = sqrt(B - C^2/4)), so every block
is a signed combination of the first-order closed forms at complex decays,
through the Faddeeva function (``ops/special.py``).

Inputs are (time, function index): an index below ``output_dim`` is output j,
``output_dim + r`` is latent force r. Every exp * erf product goes through a
form whose exponent is already cancelled (``_exp_diferf``, ``_upsilon``); a
discarded branch gets safe arguments, so no inf reaches a select's pullback.

Lanes: ``W`` is ``lanes + (P, R)``, ``lengthscale`` ``lanes + (R,)``, ``decay``,
``C``, ``B`` ``lanes + (P,)``. Per-row parameters are read through one-hot
rows of the index column (a sum, not a gather: its backward is a fixed-order
reduction). The complex dtype follows the real one (complex64 for float32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.special import complex_dtype, wofz
from .base import Kernel, as_leaf, grid, placement

_SQPI = 1.7724538509055159


def _erf(x):
    return torch.special.erf(x)


def _erfcx(x):
    """erfcx(x) = exp(x^2) erfc(x) for real x, as Re[w(i x)] (the reference's
    route, through the same Faddeeva approximation)."""
    return wofz(1j * x).real


def _exp_diferf(c, z1, z2):
    """exp(c) (erf(z2) - erf(z1)) without overflow (eq_ode1.py:633-649's
    lnDifErf, branchless): z1 > 0 and z2 < 0 through erfcx with the exponent
    cancelled, z1 <= 0 <= z2 directly (c <= 0 there at every call site)."""
    c, z1, z2 = torch.broadcast_tensors(c, z1, z2)
    inA = z1 > 0.0
    inB = (~inA) & (z2 < 0.0)
    one, two, zero = torch.ones_like(c), 2.0 * torch.ones_like(c), torch.zeros_like(c)

    def regimeA(cm, a1, a2):
        return torch.exp(cm - torch.square(a1)) * (
            _erfcx(a1) - _erfcx(a2) * torch.exp(torch.square(a1) - torch.square(a2)))

    vA = regimeA(torch.where(inA, c, zero), torch.where(inA, z1, one), torch.where(inA, z2, two))
    vB = regimeA(torch.where(inB, c, zero), torch.where(inB, -z2, one),
                 torch.where(inB, -z1, two))
    safe_c = torch.where(inA | inB, zero, torch.clamp(c, max=80.0))
    vC = torch.exp(safe_c) * (_erf(z2) - _erf(z1))
    return torch.where(inA, vA, torch.where(inB, vB, vC))


def _index(X):
    return torch.round(X[..., -1].detach()).long()


def _onehot(i, n, dtype):
    return torch.nn.functional.one_hot(i.clamp(0, n - 1), n).to(dtype)


def _rows(v, E):
    """v[..., idx] through the one-hot rows E (N, P): ``lanes + (N,)``."""
    return torch.sum(v[..., None, :] * E, dim=-1)


def _k_uu(t, t2, l):
    return torch.exp(-torch.square(t - t2) / torch.square(l))


class _LFM(Kernel):
    """The (time, index) layout and block assembly shared by EQ_ODE1 and 2."""

    def _layout(self, X, X2):
        X2 = X if X2 is None else X2
        i1, i2 = _index(X), _index(X2)
        P = self.output_dim
        dtype = X.dtype
        E1, E2 = _onehot(i1, P, dtype), _onehot(i2, P, dtype)
        return X2, i1, i2, E1, E2

    def Kdiag(self, X):
        return self._pairwise_diag(X)


@dataclasses.dataclass(frozen=True)
class EQ_ODE1(_LFM):
    """First-order LFM (SIM) kernel (eq_ode1.py)."""

    W: torch.Tensor = None            # (output_dim, rank) sensitivities
    lengthscale: torch.Tensor = None  # (rank,)
    decay: torch.Tensor = None        # (output_dim,)
    output_dim: int = 1
    rank: int = 1

    @classmethod
    def create(cls, output_dim=1, rank=1, W=None, lengthscale=None, decay=None, seed=0,
               dtype=None, device=None):
        where = placement(dtype, device)
        rng = np.random.default_rng(seed)
        if lengthscale is None:
            lengthscale = 0.5 + rng.random(rank)
        if W is None:
            W = 0.5 * rng.standard_normal((output_dim, rank)) / np.sqrt(rank)
        if decay is None:
            decay = np.ones(output_dim)
        return cls(input_dim=2, W=as_leaf(W, **where).reshape(output_dim, rank),
                   lengthscale=as_leaf(lengthscale, **where).reshape(-1).expand(rank).clone(),
                   decay=as_leaf(decay, **where).reshape(-1).expand(output_dim).clone(),
                   output_dim=output_dim, rank=rank)

    def _k_fu(self, t, d, t2, l):
        """Cov[y_j(t), u(t')]: (sqrt(pi) l / 2) exp(nu^2 - d (t - t'))
        [erf((t - t')/l - nu) + erf(t'/l + nu)], nu = d l / 2."""
        nu = d * l / 2.0
        tau = t - t2
        return (_SQPI * l / 2.0) * _exp_diferf(torch.square(nu) - d * tau, nu - tau / l,
                                               t2 / l + nu)

    def _h(self, t, t2, dj, dk, l):
        nu = dk * l / 2.0
        tau = t - t2
        term1 = _exp_diferf(torch.square(nu) - dk * tau, nu - tau / l, t2 / l + nu)
        term2 = _exp_diferf(torch.square(nu) - (dk * t + dj * t2), nu - t / l,
                            nu * torch.ones_like(t - t2))
        return (term1 - term2) / (dj + dk)

    def _k_ff(self, t, dj, t2, dk, l):
        return (_SQPI * l / 2.0) * (self._h(t2, t, dj, dk, l) + self._h(t, t2, dk, dj, l))

    def K(self, X, X2=None):
        X2, i1, i2, E1, E2 = self._layout(X, X2)
        P = self.output_dim
        is_out1, is_out2 = (i1 < P)[:, None], (i2 < P)[None, :]
        d1, d2 = _rows(self.decay, E1), _rows(self.decay, E2)
        T1, T2 = X[:, 0, None], X2[None, :, 0]
        T1r, T2c = X[None, :, 0], X2[:, 0, None]
        out = 0.0
        for r in range(self.rank):
            l = grid(self.lengthscale[..., r])
            w1, w2 = _rows(self.W[..., r], E1), _rows(self.W[..., r], E2)
            ff = w1[..., :, None] * w2[..., None, :] * self._k_ff(
                T1, d1[..., :, None], T2, d2[..., None, :], l)
            lat2_is_r, lat1_is_r = (i2 == P + r)[None, :], (i1 == P + r)[:, None]
            fu = w1[..., :, None] * self._k_fu(T1, d1[..., :, None], T2, l)
            uf = w2[..., None, :] * self._k_fu(T2c, d2[..., :, None], T1r, l).mT
            out = (out + torch.where(is_out1 & is_out2, ff, 0.0)
                   + torch.where(is_out1 & lat2_is_r, fu, 0.0)
                   + torch.where(lat1_is_r & is_out2, uf, 0.0)
                   + torch.where(lat1_is_r & lat2_is_r, _k_uu(T1, T2, l), 0.0))
        return out


def _wofz_any(z):
    """w on the whole plane: w(z) = 2 exp(-z^2) - w(-z) for Im(z) < 0."""
    lower = z.imag < 0
    w_up = wofz(torch.where(lower, -z, z))
    return torch.where(lower, 2.0 * torch.exp(-(z ** 2)) - w_up, w_up)


def _upsilon(g, l, t, t2):
    """e^{nu^2 - g (t - t')} [erf((t - t')/l - nu) + erf(t'/l + nu)], nu = g l / 2,
    for complex g, every exponent with a bounded real part."""
    nu = g * l / 2.0
    tau = t - t2
    term1 = 2.0 * torch.exp(nu ** 2 - g * tau)
    term2 = torch.exp(-((tau / l) ** 2)) * _wofz_any(1j * (tau / l - nu))
    term3 = torch.exp(-g * t - (t2 / l) ** 2) * _wofz_any(1j * (t2 / l + nu))
    return term1 - term2 - term3


def _upsilon0(gk, gj, l, t, t2):
    """e^{nu_k^2 - gk t - gj t'} [erf(t/l - nu_k) + erf(nu_k)]."""
    nu = gk * l / 2.0
    term1 = 2.0 * torch.exp(nu ** 2 - gk * t - gj * t2)
    term2 = torch.exp(-((t / l) ** 2) - gj * t2) * _wofz_any(1j * (t / l - nu))
    term3 = torch.exp(-gk * t - gj * t2) * wofz(1j * nu)
    return term1 - term2 - term3


def _h_complex(t, t2, gj, gk, l):
    return (_upsilon(gk, l, t, t2) - _upsilon0(gk, gj, l, t, t2)) / (gj + gk)


def _kff1_complex(t, gj, t2, gk, l):
    return (_SQPI * l / 2.0) * (_h_complex(t2, t, gj, gk, l) + _h_complex(t, t2, gk, gj, l))


@dataclasses.dataclass(frozen=True)
class EQ_ODE2(_LFM):
    """Second-order LFM (eq_ode2.py); the same input layout as EQ_ODE1."""

    W: torch.Tensor = None            # (output_dim, rank)
    lengthscale: torch.Tensor = None  # (rank,)
    C: torch.Tensor = None            # (output_dim,) damping
    B: torch.Tensor = None            # (output_dim,) spring
    output_dim: int = 1
    rank: int = 1

    @classmethod
    def create(cls, output_dim=1, rank=1, W=None, lengthscale=None, C=None, B=None, seed=0,
               dtype=None, device=None):
        where = placement(dtype, device)
        rng = np.random.default_rng(seed)
        if lengthscale is None:
            lengthscale = 0.5 + rng.random(rank)
        if W is None:
            W = 0.5 * rng.standard_normal((output_dim, rank)) / np.sqrt(rank)
        C = np.ones(output_dim) if C is None else C
        B = np.ones(output_dim) if B is None else B

        def per_output(v):
            return as_leaf(v, **where).reshape(-1).expand(output_dim).clone()

        return cls(input_dim=2, W=as_leaf(W, **where).reshape(output_dim, rank),
                   lengthscale=as_leaf(lengthscale, **where).reshape(-1).expand(rank).clone(),
                   C=per_output(C), B=per_output(B), output_dim=output_dim, rank=rank)

    def _gammas(self):
        alpha = self.C / 2.0
        omega = torch.sqrt(self.B.to(complex_dtype(self.B.dtype)) - alpha ** 2)
        return alpha + 1j * omega, alpha - 1j * omega, omega

    @staticmethod
    def _fu_grid(g1, g2, om, l, T_out, T_lat):
        """Cov[y(t_out), u(t_lat)]:
        Re{(sqrt(pi) l / 2) [Upsilon(g2) - Upsilon(g1)] / (2 i omega)}."""
        up = _upsilon(g2, l, T_out, T_lat) - _upsilon(g1, l, T_out, T_lat)
        return ((_SQPI * l / 2.0) * up / (2j * om)).real

    @staticmethod
    def _ff_grid(a1, a2, oj, b1, b2, ok, l, T1, T2):
        num = (_kff1_complex(T1, a2, T2, b2, l) - _kff1_complex(T1, a2, T2, b1, l)
               - _kff1_complex(T1, a1, T2, b2, l) + _kff1_complex(T1, a1, T2, b1, l))
        return (num / (-4.0 * oj * ok)).real

    def K(self, X, X2=None):
        X2, i1, i2, E1, E2 = self._layout(X, X2)
        P = self.output_dim
        is_out1, is_out2 = (i1 < P)[:, None], (i2 < P)[None, :]
        g1, g2, omega = self._gammas()
        C1, C2 = E1.to(g1.dtype), E2.to(g1.dtype)
        a1, a2, oj = (_rows(v, C1)[..., :, None] for v in (g1, g2, omega))
        b1, b2, ok = (_rows(v, C2)[..., None, :] for v in (g1, g2, omega))
        T1, T2 = X[:, 0, None], X2[None, :, 0]
        out = 0.0
        for r in range(self.rank):
            l = grid(self.lengthscale[..., r])
            w1, w2 = _rows(self.W[..., r], E1), _rows(self.W[..., r], E2)
            ff = w1[..., :, None] * w2[..., None, :] * self._ff_grid(a1, a2, oj, b1, b2, ok, l,
                                                                     T1, T2)
            lat2_is_r, lat1_is_r = (i2 == P + r)[None, :], (i1 == P + r)[:, None]
            fu = w1[..., :, None] * self._fu_grid(a1, a2, oj, l, T1, T2)
            # rows are the latent times, columns the outputs
            uf = w2[..., None, :] * self._fu_grid(b1, b2, ok, l, T2, T1)
            out = (out + torch.where(is_out1 & is_out2, ff, 0.0)
                   + torch.where(is_out1 & lat2_is_r, fu, 0.0)
                   + torch.where(lat1_is_r & is_out2, uf, 0.0)
                   + torch.where(lat1_is_r & lat2_is_r, _k_uu(T1, T2, l), 0.0))
        return out

    def Kdiag_per_force(self, X):
        """Per-force diagonal, ``lanes + (N, R)``: w_{d_n r}^2 k^(r)_ff(t_n, t_n)
        on output rows, the indicator of the row's own force on latent rows
        (the reference's ``kern._Kdiag``, the IBP-LFM's psi-0 statistic)."""
        t1 = X[:, 0]
        i1 = _index(X)
        P = self.output_dim
        is_out = i1 < P
        E = _onehot(i1, P, X.dtype)
        g1, g2, omega = self._gammas()
        Ec = E.to(g1.dtype)
        a1, a2, oj = (_rows(v, Ec) for v in (g1, g2, omega))
        cols = []
        for r in range(self.rank):
            l = self.lengthscale[..., r, None]
            w = _rows(self.W[..., r], E)
            ff = w * w * self._ff_grid(a1, a2, oj, a1, a2, oj, l, t1, t1)
            cols.append(torch.where(is_out, ff, (i1 == P + r).to(X.dtype)))
        return torch.stack(cols, dim=-1)

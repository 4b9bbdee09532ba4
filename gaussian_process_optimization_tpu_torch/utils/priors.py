"""Hyperparameter priors (twin of ``gaussian_process_optimization_tpu/utils/priors.py``;
GPy core/parameterization/priors.py: Gaussian:40, Uniform:94, LogGaussian,
Gamma:264 with from_EV, InverseGamma, Exponential, StudentT, HalfT).

A prior gives the log-density of a *constrained* parameter value, elementwise;
the fit objective is -logL - logPrior (GPy core/model.py:101-127) and its
gradient comes from autograd through the density. A prior's own parameters are
floats or tensors.

The multivariate Gaussian prior and the discriminative-GPLVM priors (GPy
priors.py:188, :388, :535, :749, :994) read a whole (N, Q) leaf at once: their
``lnpdf`` keeps any leading lane axes of the leaf and gives one value per lane
(the multivariate Gaussian one per row), which the fit objective sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


def _t(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Prior:
    def lnpdf(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GaussianPrior(Prior):
    mu: Any = 0.0
    sigma: Any = 1.0

    def lnpdf(self, x):
        s2 = torch.square(_t(self.sigma, x))
        return -0.5 * (torch.log(2 * math.pi * s2) + torch.square(x - _t(self.mu, x)) / s2)


@dataclasses.dataclass(frozen=True)
class UniformPrior(Prior):
    lower: Any = 0.0
    upper: Any = 1.0

    def lnpdf(self, x):
        lo, hi = _t(self.lower, x), _t(self.upper, x)
        inside = (x >= lo) & (x <= hi)
        return torch.where(inside, -torch.log(hi - lo).expand(x.shape),
                           torch.full_like(x, -float("inf")))


@dataclasses.dataclass(frozen=True)
class LogGaussianPrior(Prior):
    mu: Any = 0.0
    sigma: Any = 1.0

    def lnpdf(self, x):
        s2 = torch.square(_t(self.sigma, x))
        lx = torch.log(x)
        return -lx - 0.5 * (torch.log(2 * math.pi * s2) + torch.square(lx - _t(self.mu, x)) / s2)


@dataclasses.dataclass(frozen=True)
class GammaPrior(Prior):
    """Shape / rate parameterization, as GPy (priors.py:264)."""

    a: Any = 1.0
    b: Any = 1.0  # rate

    @classmethod
    def from_EV(cls, E, V):
        """From expectation and variance (GPy Gamma.from_EV)."""
        return cls(a=E * E / V, b=E / V)

    def lnpdf(self, x):
        a, b = _t(self.a, x), _t(self.b, x)
        return a * torch.log(b) - torch.lgamma(a) + (a - 1.0) * torch.log(x) - b * x


@dataclasses.dataclass(frozen=True)
class InverseGammaPrior(Prior):
    a: Any = 1.0
    b: Any = 1.0

    def lnpdf(self, x):
        a, b = _t(self.a, x), _t(self.b, x)
        return a * torch.log(b) - torch.lgamma(a) - (a + 1.0) * torch.log(x) - b / x


@dataclasses.dataclass(frozen=True)
class ExponentialPrior(Prior):
    l: Any = 1.0  # noqa: E741  (the reference's field name)

    def lnpdf(self, x):
        rate = _t(self.l, x)
        return torch.log(rate) - rate * x


@dataclasses.dataclass(frozen=True)
class StudentTPrior(Prior):
    mu: Any = 0.0
    sigma: Any = 1.0
    nu: Any = 4.0

    def lnpdf(self, x):
        mu, sigma, nu = _t(self.mu, x), _t(self.sigma, x), _t(self.nu, x)
        z = (x - mu) / sigma
        return (torch.lgamma((nu + 1) / 2) - torch.lgamma(nu / 2)
                - 0.5 * torch.log(nu * math.pi) - torch.log(sigma)
                - (nu + 1) / 2 * torch.log1p(torch.square(z) / nu))


@dataclasses.dataclass(frozen=True)
class HalfTPrior(Prior):
    A: Any = 1.0
    nu: Any = 4.0

    def lnpdf(self, x):
        t = StudentTPrior(mu=0.0, sigma=self.A, nu=self.nu)
        return torch.where(x >= 0, math.log(2.0) + t.lnpdf(x),
                           torch.full_like(x, -float("inf")))


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """A leaf as ``lanes + (n, d)``: an ``(n, d)`` leaf (with lanes in front)
    as it is, anything else reshaped to ``(n, -1)`` as the reference does."""
    if x.ndim >= 2 and x.shape[-2] == n:
        return x
    return x.reshape(n, -1)


@dataclasses.dataclass(frozen=True)
class MultivariateGaussianPrior(Prior):
    """Multivariate normal over the rows of x (priors.py:188): one log-density
    per row, ``lanes + (rows,)``."""

    mu: Any = 0.0
    var: Any = 1.0  # (d, d) covariance

    def lnpdf(self, x):
        mu = torch.atleast_1d(_t(self.mu, x))
        d = mu.shape[0]
        L = torch.linalg.cholesky(_t(self.var, x))
        dev = (x.reshape(x.shape[:-1] + (-1, d)) if x.ndim >= 2 and x.shape[-1] == d
               else x.reshape(-1, d)) - mu
        z = torch.linalg.solve_triangular(L, dev.transpose(-1, -2), upper=False)
        const = -0.5 * d * math.log(2 * math.pi) - torch.sum(torch.log(torch.diagonal(L)))
        return const - 0.5 * torch.sum(torch.square(z), dim=-2)


def _class_scatter(x: torch.Tensor, lbl: torch.Tensor):
    """(Sb, Sw), the between- and within-class scatter of the rows of x
    (``lanes + (N, d)``) under one-hot labels ``lbl (N, C)``, N-normalized as
    the reference's loops (priors.py:566-631); an empty class adds nothing."""
    lbl = lbl.to(x.dtype)
    n = x.shape[-2]
    counts = torch.sum(lbl, dim=0)
    M_i = (lbl.transpose(0, 1) @ x) / torch.clamp(counts, min=1.0)[:, None]
    B = M_i - torch.mean(x, dim=-2, keepdim=True)
    Sb = torch.einsum("c,...ci,...cj->...ij", counts / n, B, B)
    W = x - lbl @ M_i
    return Sb, (W.transpose(-1, -2) @ W) / n


@dataclasses.dataclass(frozen=True)
class DGPLVMPrior(Prior):
    """Discriminative GPLVM prior on the latent X (priors.py:535, Urtasun &
    Darrell's LDA criterion): lnpdf(X) = -(1 / sigma2) tr((Sb + ridge I)^-1 Sw),
    ``lbl`` the (N, C) one-hot labels, ridge the reference's 0.1."""

    lbl: Any = None
    sigma2: Any = 1.0
    ridge: float = 0.1

    def lnpdf(self, x):
        lbl = _t(self.lbl, x)
        Sb, Sw = _class_scatter(_rows(x, lbl.shape[0]), lbl)
        A = Sb + self.ridge * torch.eye(Sb.shape[-1], dtype=x.dtype, device=x.device)
        return (-1.0 / _t(self.sigma2, x)) * torch.diagonal(
            torch.linalg.solve(A, Sw), dim1=-2, dim2=-1).sum(-1)


@dataclasses.dataclass(frozen=True)
class DGPLVMLamdaPrior(Prior):
    """DGPLVM on X diag(lamda), ridge 0.9 (priors.py:749 DGPLVM_Lamda)."""

    lbl: Any = None
    lamda: Any = None  # (d,)
    sigma2: Any = 1.0
    ridge: float = 0.9

    def lnpdf(self, x):
        lbl = _t(self.lbl, x)
        return DGPLVMPrior(lbl=lbl, sigma2=self.sigma2, ridge=self.ridge).lnpdf(
            _rows(x, lbl.shape[0]) * _t(self.lamda, x))


@dataclasses.dataclass(frozen=True)
class DGPLVMTPrior(Prior):
    """DGPLVM on the projection X vec, ridge 0.1 (priors.py:994 DGPLVM_T)."""

    lbl: Any = None
    vec: Any = None  # (d, d')
    sigma2: Any = 1.0
    ridge: float = 0.1

    def lnpdf(self, x):
        lbl = _t(self.lbl, x)
        return DGPLVMPrior(lbl=lbl, sigma2=self.sigma2, ridge=self.ridge).lnpdf(
            _rows(x, lbl.shape[0]) @ _t(self.vec, x))


@dataclasses.dataclass(frozen=True)
class DGPLVMKFDAPrior(Prior):
    """Kernel Fisher discriminant DGPLVM prior, two classes (priors.py:388
    DGPLVM_KFDA): with K = kern.K(X), A the blockwise centring operator and a
    the signed class indicator,
    J = (a^T K a - a^T K A (lambdaa I + A K A)^-1 A K a) / lambdaa and
    lnpdf(X) = -J / sigma2. ``a`` and ``A`` are built from the labels (the
    reference's positional build, on class-sorted rows, is the same)."""

    lbl: Any = None  # (N, 2) one-hot
    kern: Any = None
    lambdaa: Any = 1e-4
    sigma2: Any = 1.0

    def _aA(self, like):
        lbl = _t(self.lbl, like)[:, :2]
        counts = torch.clamp(torch.sum(lbl, dim=0), min=1.0)
        a = lbl[:, 0] / counts[0] - lbl[:, 1] / counts[1]
        A = sum((torch.diag(lbl[:, i]) - torch.outer(lbl[:, i], lbl[:, i]) / counts[i])
                / torch.sqrt(counts[i]) for i in range(2))
        return a, A

    def lnpdf(self, x):
        n = torch.as_tensor(self.lbl).shape[0]
        K = self.kern.K(_rows(x, n))
        a, A = self._aA(K)
        Ka = (K @ a[:, None])[..., 0]
        AKa = (A @ Ka[..., None])[..., 0]
        lam = _t(self.lambdaa, x)
        P = lam * torch.eye(n, dtype=K.dtype, device=K.device) + A @ K @ A
        J = Ka @ a - torch.sum(AKa * torch.linalg.solve(P, AKa[..., None])[..., 0], dim=-1)
        return (-1.0 / _t(self.sigma2, x)) * (J / lam)


def _flatten(tree, is_prior_side: bool) -> list:
    """Leaves of a nested structure (dataclasses by field, dicts by sorted key,
    tuples and lists by item); None is a leaf on both sides, a Prior is a leaf
    on the priors side."""
    if tree is None or isinstance(tree, torch.Tensor):
        return [tree]
    if is_prior_side and isinstance(tree, Prior):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k], is_prior_side)]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _flatten(item, is_prior_side)]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _flatten(getattr(tree, f.name), is_prior_side)]
    return [tree]


def log_prior(priors, params) -> torch.Tensor:
    """Sum of prior log-densities. ``priors`` mirrors the structure of
    ``params`` leaf for leaf: a Prior is applied to the parameter in its place,
    None contributes nothing (``log_prior``, priors.py:283)."""
    if priors is None:
        return torch.zeros(())
    flat_priors = _flatten(priors, True)
    flat_params = _flatten(params, False)
    if len(flat_priors) != len(flat_params):
        raise ValueError(
            f"priors tree must mirror the params tree leaf-for-leaf "
            f"({len(flat_priors)} vs {len(flat_params)} leaves — use None "
            f"for unpriored slots)")
    total = None
    for pr, v in zip(flat_priors, flat_params):
        if isinstance(pr, Prior):
            if v is None:
                raise ValueError("a Prior was placed on a None parameter slot")
            term = torch.sum(pr.lnpdf(torch.as_tensor(v)))
            total = term if total is None else total + term
    return torch.zeros(()) if total is None else total

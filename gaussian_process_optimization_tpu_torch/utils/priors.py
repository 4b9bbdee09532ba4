"""Hyperparameter priors (twin of ``gaussian_process_optimization_tpu/utils/priors.py``;
GPy core/parameterization/priors.py: Gaussian:40, Uniform:94, LogGaussian,
Gamma:264 with from_EV, InverseGamma, Exponential, StudentT, HalfT).

A prior gives the log-density of a *constrained* parameter value, elementwise;
the fit objective is -logL - logPrior (GPy core/model.py:101-127) and its
gradient comes from autograd through the density. A prior's own parameters are
floats or tensors. The multivariate Gaussian prior and the discriminative-GPLVM
priors of the reference are not ported (they serve the GPLVM models).
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

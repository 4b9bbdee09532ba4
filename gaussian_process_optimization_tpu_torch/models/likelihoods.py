"""Likelihoods (twin of ``gaussian_process_optimization_tpu/models/likelihoods.py``;
GPy likelihoods/: gaussian.py:22, bernoulli, poisson, student_t, binomial, gamma,
exponential, weibull, loggaussian, loglogistic, mixed_noise, multioutput_likelihood,
link_functions).

Each likelihood gives log p(y|f) and its first two derivatives in f (analytic where
the reference writes them, otherwise by autograd through ``logpdf``), the
Gauss-Hermite predictive marginals and EP moments (the reference's quadrature
fallbacks, likelihood.py), observation draws and predictive quantiles.

The generic derivatives keep their graph (``create_graph=True``): Laplace's
gradient differentiates ``d2logpdf_df2`` once more. A scalar parameter may carry
a leading lane axis (the Fitter's restarts); it is broadcast against ``f`` from
the left. Per-point parameters (``Binomial.trials``, the heteroscedastic
variances, ``output_index``) follow the reference's shapes and take no lanes.

Observation draws (``samples``) come from a numpy ``Generator`` on the host, as
GPy draws them; the draws' distribution is the reference's, not its stream.
"""
from __future__ import annotations

import dataclasses
import inspect
import math

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT2 = math.sqrt(2.0)


def _bc(v, f):
    """A parameter with lane axes ``v.shape`` broadcast against ``f`` from the
    left (its trailing axes are data or quadrature axes)."""
    if not isinstance(v, torch.Tensor) or v.ndim == 0 or v.ndim >= f.ndim:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (f.ndim - v.ndim))


def _norm_logpdf(z):
    return -0.5 * torch.square(z) - 0.5 * _LOG_2PI


def _Phi(f):
    return 0.5 * torch.special.erfc(-f / _SQRT2)


def _hermgauss(n, like):
    x, w = np.polynomial.hermite.hermgauss(n)
    return (torch.as_tensor(x, dtype=like.dtype, device=like.device),
            torch.as_tensor(w, dtype=like.dtype, device=like.device))


def _scalar(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device).reshape(())


def _new(dtype, device):
    device = resolve_device(device)
    return resolve_dtype(dtype, device), device


def _host_draw(f, values):
    """numpy draws as a tensor like ``f``."""
    return torch.as_tensor(np.asarray(values, dtype=float), dtype=f.dtype, device=f.device)


def _np(t):
    return t.detach().cpu().numpy().astype(float) if isinstance(t, torch.Tensor) else t


def _rng(rng):
    return np.random.default_rng(0) if rng is None else rng


@dataclasses.dataclass(frozen=True)
class Likelihood:
    def logpdf(self, f, y):
        raise NotImplementedError

    def dlogpdf_df(self, f, y):
        """d log p / df by autograd (the reference's ``jax.grad``); the graph
        is kept, so the result is differentiable again."""
        outer = torch.is_grad_enabled()
        with torch.enable_grad():
            ff = f if f.requires_grad else f.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.logpdf(ff, y).sum(), ff, create_graph=True)
        return g if outer else g.detach()

    def d2logpdf_df2(self, f, y):
        """The diagonal Hessian: the likelihood factorizes over points, so
        d/df_i sum_j dlogpdf_j is d2logpdf_i."""
        outer = torch.is_grad_enabled()
        with torch.enable_grad():
            ff = f if f.requires_grad else f.detach().requires_grad_(True)
            g = self.dlogpdf_df(ff, y)
            (h,) = torch.autograd.grad(g.sum(), ff, create_graph=True, allow_unused=True,
                                       materialize_grads=True)
        return h if outer else h.detach()

    def predictive(self, mu, var, gh_points=20):
        """E[y*], V[y*] by Gauss-Hermite over the latent marginal."""
        gh_x, gh_w = _hermgauss(gh_points, mu)
        gh_w = gh_w / math.sqrt(math.pi)
        f = mu[..., None] + torch.sqrt(2.0 * var[..., None]) * gh_x
        cm = self.conditional_mean(f)
        ey = torch.sum(gh_w * cm, -1)
        ey2 = torch.sum(gh_w * (self.conditional_variance(f) + cm ** 2), -1)
        return ey, torch.clamp(ey2 - ey ** 2, min=1e-15)

    def conditional_mean(self, f):
        raise NotImplementedError

    def conditional_variance(self, f):
        raise NotImplementedError

    def samples(self, f, rng=None):
        """One observation draw y ~ p(y|f) per latent entry, shaped like f
        (GPy likelihood.py samples:769); ``rng`` a numpy Generator."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement observation sampling")

    def predictive_quantiles(self, mu, var, quantiles, rng=None, n_samples=300, draws=None):
        """Sampling-based predictive quantiles (GPy likelihood.py:757-766):
        latent draws f ~ N(mu, var) corrupted through ``samples``, then
        percentiles. ``quantiles`` in percent; a list of ``(N, 1)`` tensors.
        ``draws`` (N, S), if given, are the observation draws to take the
        percentiles of (an injected draw)."""
        mu = mu.reshape(-1)
        var = var.reshape(-1)
        if draws is None:
            rng = _rng(rng)
            z = _host_draw(mu, rng.standard_normal((mu.shape[0], n_samples)))
            draws = self.samples(mu[:, None] + torch.sqrt(var)[:, None] * z, rng)
        if not isinstance(draws, torch.Tensor):
            draws = torch.as_tensor(np.array(draws, dtype=float), dtype=mu.dtype,
                                    device=mu.device)
        return [torch.quantile(draws, q / 100.0, dim=1)[:, None] for q in quantiles]

    def log_predictive_density(self, y, mu, var, gh_points=32):
        """log p(y*|D) = log int p(y*|f) N(f; mu, var) df by Gauss-Hermite in
        log space (GPy likelihood.py log_predictive_density)."""
        gh_x, gh_w = _hermgauss(gh_points, mu)
        log_w = torch.log(gh_w) - 0.5 * math.log(math.pi)
        f = mu[..., None] + torch.sqrt(2.0 * var[..., None]) * gh_x
        lp = self.logpdf(f, torch.as_tensor(y, dtype=mu.dtype, device=mu.device)[..., None])
        return torch.logsumexp(lp + log_w, dim=-1)

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=32):
        """EP moments against the cavity N(v/tau, 1/tau): (log Z_hat, mu_hat,
        sigma2_hat), by Gauss-Hermite in log space (GPy likelihood.py
        moments_match_ep)."""
        gh_x, gh_w = _hermgauss(gh_points, tau_cav)
        log_gh_w = torch.log(gh_w) - 0.5 * math.log(math.pi)
        mu_cav = v_cav / tau_cav
        s_cav = torch.sqrt(2.0 / tau_cav)
        f = mu_cav[..., None] + s_cav[..., None] * gh_x
        a = log_gh_w + self.logpdf(f, y[..., None])
        amax = torch.amax(a, dim=-1, keepdim=True)
        w = torch.exp(a - amax)
        Z = torch.sum(w, dim=-1)
        logZ = torch.log(Z) + amax[..., 0]
        mu_hat = torch.sum(w * f, dim=-1) / Z
        e2 = torch.sum(w * torch.square(f), dim=-1) / Z
        return logZ, mu_hat, torch.clamp(e2 - torch.square(mu_hat), min=1e-12)


@dataclasses.dataclass(frozen=True)
class GaussianLik(Likelihood):
    """(likelihoods/gaussian.py:22)"""

    variance: torch.Tensor = None

    @classmethod
    def create(cls, variance=1.0, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(variance=_scalar(variance, dtype, device))

    def logpdf(self, f, y):
        v = _bc(self.variance, f)
        return -0.5 * (torch.log(2 * math.pi * v) + torch.square(y - f) / v)

    def dlogpdf_df(self, f, y):
        return (y - f) / _bc(self.variance, f)

    def d2logpdf_df2(self, f, y):
        return -torch.ones_like(f) / _bc(self.variance, f)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return _bc(self.variance, f).expand(f.shape)

    def samples(self, f, rng=None):
        z = _host_draw(f, _rng(rng).standard_normal(tuple(f.shape)))
        return f + torch.sqrt(self.variance) * z

    def predictive_quantiles(self, mu, var, quantiles, rng=None, n_samples=None, draws=None):
        """Closed form (GPy gaussian.py predictive_quantiles): mu + ppf * sd
        with sd over latent var + noise."""
        mu = mu.reshape(-1, 1)
        sd = torch.sqrt(var.reshape(-1, 1) + self.variance)
        return [mu + float(torch.special.ndtri(torch.tensor(q / 100.0, dtype=torch.float64)))
                * sd for q in quantiles]

    def log_predictive_density(self, y, mu, var, gh_points=None):
        tot = var + self.variance
        return -0.5 * (torch.log(2 * math.pi * tot) + torch.square(y - mu) / tot)

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=None):
        """Exact Gaussian-site moments (GPy gaussian.py moments_match_ep)."""
        s2_cav = 1.0 / tau_cav
        mu_cav = v_cav * s2_cav
        tot = self.variance + s2_cav
        logZ = -0.5 * (torch.log(2 * math.pi * tot) + torch.square(y - mu_cav) / tot)
        mu_hat = (self.variance * mu_cav + s2_cav * y) / tot
        return logZ, mu_hat, self.variance * s2_cav / tot


@dataclasses.dataclass(frozen=True)
class Bernoulli(Likelihood):
    """Probit-link Bernoulli (GPy likelihoods/bernoulli.py); y in {0,1} or {-1,1}."""

    def _z(self, f, y):
        ypm = torch.where(y > 0, 1.0, -1.0).to(f.dtype)
        return ypm * f, ypm

    def logpdf(self, f, y):
        z, _ = self._z(f, y)
        return torch.special.log_ndtr(z)

    def dlogpdf_df(self, f, y):
        z, ypm = self._z(f, y)
        # N(z) / Phi(z) as exp(logpdf - logcdf)
        return ypm * torch.exp(_norm_logpdf(z) - torch.special.log_ndtr(z))

    def d2logpdf_df2(self, f, y):
        z, _ = self._z(f, y)
        ratio = torch.exp(_norm_logpdf(z) - torch.special.log_ndtr(z))
        return -(ratio ** 2) - z * ratio

    def conditional_mean(self, f):
        return _Phi(f)

    def conditional_variance(self, f):
        p = self.conditional_mean(f)
        return p * (1 - p)

    def predictive(self, mu, var, gh_points=None):
        """Closed-form probit predictive: p = Phi(mu / sqrt(1 + var))."""
        p = _Phi(mu / torch.sqrt(1.0 + var))
        return p, p * (1 - p)

    def samples(self, f, rng=None):
        return _host_draw(f, _rng(rng).binomial(1, _np(self.conditional_mean(f))))

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=None):
        """Exact probit moments (GPML 3.58-3.59, GPy bernoulli.py moments_match_ep)."""
        ypm = torch.where(y > 0, 1.0, -1.0).to(tau_cav.dtype)
        s2_cav = 1.0 / tau_cav
        mu_cav = v_cav * s2_cav
        denom = torch.sqrt(1.0 + s2_cav)
        z = ypm * mu_cav / denom
        logZ = torch.special.log_ndtr(z)
        ratio = torch.exp(_norm_logpdf(z) - logZ)
        mu_hat = mu_cav + ypm * s2_cav * ratio / denom
        sigma2_hat = s2_cav - torch.square(s2_cav) * ratio * (z + ratio) / (1.0 + s2_cav)
        return logZ, mu_hat, torch.clamp(sigma2_hat, min=1e-12)


@dataclasses.dataclass(frozen=True)
class Poisson(Likelihood):
    """Exp-link Poisson (GPy likelihoods/poisson.py); y non-negative counts."""

    def logpdf(self, f, y):
        return y * f - torch.exp(f) - torch.lgamma(y + 1.0)

    def dlogpdf_df(self, f, y):
        return y - torch.exp(f)

    def d2logpdf_df2(self, f, y):
        return -torch.exp(f)

    def conditional_mean(self, f):
        return torch.exp(f)

    def conditional_variance(self, f):
        return torch.exp(f)

    def samples(self, f, rng=None):
        return _host_draw(f, _rng(rng).poisson(_np(torch.exp(f))))


@dataclasses.dataclass(frozen=True)
class StudentT(Likelihood):
    """Student-t observation noise (GPy likelihoods/student_t.py)."""

    deg_free: torch.Tensor = None
    sigma2: torch.Tensor = None

    @classmethod
    def create(cls, deg_free=5.0, sigma2=2.0, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(deg_free=_scalar(deg_free, dtype, device),
                   sigma2=_scalar(sigma2, dtype, device))

    def logpdf(self, f, y):
        v, s2 = _bc(self.deg_free, f), _bc(self.sigma2, f)
        e2 = torch.square(y - f)
        return (torch.lgamma((v + 1) / 2) - torch.lgamma(v / 2)
                - 0.5 * torch.log(s2 * v * math.pi)
                - (v + 1) / 2 * torch.log1p(e2 / (v * s2)))

    def dlogpdf_df(self, f, y):
        v, s2 = _bc(self.deg_free, f), _bc(self.sigma2, f)
        e = y - f
        return (v + 1) * e / (v * s2 + torch.square(e))

    def d2logpdf_df2(self, f, y):
        v, s2 = _bc(self.deg_free, f), _bc(self.sigma2, f)
        e2 = torch.square(y - f)
        return (v + 1) * (e2 - v * s2) / torch.square(v * s2 + e2)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return (self.deg_free / (self.deg_free - 2) * self.sigma2).expand(f.shape)

    def samples(self, f, rng=None):
        t = _rng(rng).standard_t(float(self.deg_free), tuple(f.shape))
        return f + torch.sqrt(self.sigma2) * _host_draw(f, t)


@dataclasses.dataclass(frozen=True)
class Binomial(Likelihood):
    """Binomial with probit link (GPy likelihoods/binomial.py): y successes out
    of ``trials`` with p = Phi(f)."""

    trials: torch.Tensor = None

    @classmethod
    def create(cls, trials, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(trials=torch.as_tensor(trials, dtype=dtype, device=device).reshape(-1))

    def _p(self, f):
        return torch.clamp(_Phi(f), 1e-9, 1 - 1e-9)

    def _n(self, f):
        # per data point; broadcast over trailing (quadrature) axes
        return self.trials.reshape((-1,) + (1,) * (f.ndim - 1))

    def logpdf(self, f, y):
        n, p = self._n(f), self._p(f)
        return (torch.lgamma(n + 1) - torch.lgamma(y + 1) - torch.lgamma(n - y + 1)
                + y * torch.log(p) + (n - y) * torch.log1p(-p))

    def conditional_mean(self, f):
        return self._n(f) * self._p(f)

    def conditional_variance(self, f):
        p = self._p(f)
        return self._n(f) * p * (1 - p)

    def samples(self, f, rng=None):
        n = np.broadcast_to(_np(self._n(f)), tuple(f.shape)).astype(np.int64)
        return _host_draw(f, _rng(rng).binomial(n, _np(self._p(f))))


@dataclasses.dataclass(frozen=True)
class GammaLik(Likelihood):
    """Gamma with exp link and fixed shape beta (GPy likelihoods/gamma.py):
    y ~ Gamma(shape=beta, rate=beta exp(-f)), so E[y] = exp(f)."""

    beta: torch.Tensor = None

    @classmethod
    def create(cls, beta=1.0, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(beta=_scalar(beta, dtype, device))

    def logpdf(self, f, y):
        b = _bc(self.beta, f)
        rate = b * torch.exp(-f)
        return b * torch.log(rate) - torch.lgamma(b) + (b - 1) * torch.log(y) - rate * y

    def conditional_mean(self, f):
        return torch.exp(f)

    def conditional_variance(self, f):
        return torch.exp(2 * f) / self.beta

    def samples(self, f, rng=None):
        # y = Gamma(beta) e^f / beta
        g = _rng(rng).gamma(float(self.beta), size=tuple(f.shape))
        return _host_draw(f, g) * torch.exp(f) / self.beta


@dataclasses.dataclass(frozen=True)
class ExponentialLik(Likelihood):
    """Exponential with exp link (GPy likelihoods/exponential.py): rate exp(-f)."""

    def logpdf(self, f, y):
        return -f - y * torch.exp(-f)

    def dlogpdf_df(self, f, y):
        return -1.0 + y * torch.exp(-f)

    def d2logpdf_df2(self, f, y):
        return -y * torch.exp(-f)

    def conditional_mean(self, f):
        return torch.exp(f)

    def conditional_variance(self, f):
        return torch.exp(2 * f)

    def samples(self, f, rng=None):
        return _host_draw(f, _rng(rng).exponential(size=tuple(f.shape))) * torch.exp(f)


@dataclasses.dataclass(frozen=True)
class HeteroscedasticGaussian(Likelihood):
    """Per-point noise variances (GPy gaussian.py HeteroscedasticGaussian:347)."""

    variances: torch.Tensor = None  # (N,)

    @classmethod
    def create(cls, variances, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(variances=torch.as_tensor(variances, dtype=dtype,
                                             device=device).reshape(-1))

    def logpdf(self, f, y):
        v = self.variances.reshape(f.shape)
        return -0.5 * (torch.log(2 * math.pi * v) + torch.square(y - f) / v)

    def dlogpdf_df(self, f, y):
        return (y - f) / self.variances.reshape(f.shape)

    def d2logpdf_df2(self, f, y):
        return -1.0 / self.variances.reshape(f.shape)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return self.variances.reshape(f.shape)

    def samples(self, f, rng=None):
        v = self.variances.reshape((-1,) + (1,) * (f.ndim - 1))
        return f + torch.sqrt(v) * _host_draw(f, _rng(rng).standard_normal(tuple(f.shape)))


# ---------------------------------------------------------------------- links
# lambda = transf(f) maps the latent GP to the likelihood's natural parameter
# (GPy likelihoods/link_functions.py); derivatives by autograd through transf.


@dataclasses.dataclass(frozen=True)
class Link:
    def transf(self, f):
        raise NotImplementedError

    def dtransf_df(self, f):
        with torch.enable_grad():
            ff = f.detach().requires_grad_(True)
            out = self.transf(ff).sum()
            if not out.requires_grad:  # a step function: zero almost everywhere
                return torch.zeros_like(f)
            (g,) = torch.autograd.grad(out, ff)
        return g


@dataclasses.dataclass(frozen=True)
class IdentityLink(Link):
    """(link_functions.py:77)"""

    def transf(self, f):
        return f


@dataclasses.dataclass(frozen=True)
class LogLink(Link):
    """lambda = exp(f) (link_functions.py:173)"""

    def transf(self, f):
        return torch.exp(f)


@dataclasses.dataclass(frozen=True)
class ProbitLink(Link):
    """lambda = Phi(f) (link_functions.py:109)"""

    def transf(self, f):
        return _Phi(f)


@dataclasses.dataclass(frozen=True)
class LogExp1Link(Link):
    """lambda = log(1 + exp(f)), softplus (link_functions.py:192 Log_ex_1)"""

    def transf(self, f):
        return torch.logaddexp(torch.zeros_like(f), f)


@dataclasses.dataclass(frozen=True)
class ReciprocalLink(Link):
    """lambda = 1/f (link_functions.py:217)"""

    def transf(self, f):
        return 1.0 / f


@dataclasses.dataclass(frozen=True)
class CloglogLink(Link):
    """lambda = 1 - exp(-exp(f)) (link_functions.py:142)"""

    def transf(self, f):
        return -torch.expm1(-torch.exp(f))


@dataclasses.dataclass(frozen=True)
class HeavisideLink(Link):
    """lambda = 1[f > 0] (link_functions.py:233); not differentiable."""

    def transf(self, f):
        return torch.where(f > 0, 1.0, 0.0).to(f.dtype)


@dataclasses.dataclass(frozen=True)
class LinkedLikelihood(Likelihood):
    """A likelihood through a link: subclasses give ``logpdf_link(link_f, y)``,
    and ``logpdf`` composes it with ``gp_link.transf`` (GPy likelihood.py)."""

    gp_link: Link = None

    def logpdf_link(self, link_f, y):
        raise NotImplementedError

    def logpdf(self, f, y):
        return self.logpdf_link(self.gp_link.transf(f), y)


def _cens(censored, y):
    if censored is None:
        return torch.zeros_like(y)
    return censored.to(y.dtype).expand(y.shape)


def _censored(censored, dtype, device):
    return None if censored is None else torch.as_tensor(np.asarray(censored, dtype=float),
                                                         dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Weibull(LinkedLikelihood):
    """Weibull survival likelihood, Log link by default (GPy weibull.py:14-80):
    log p = log r - log(lam) + (r-1) log y - y^r / lam; censored entries give
    -y^r / lam only."""

    r: torch.Tensor = None
    censored: torch.Tensor = None

    @classmethod
    def create(cls, r=1.0, gp_link=None, censored=None, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(gp_link=gp_link if gp_link is not None else LogLink(),
                   r=_scalar(r, dtype, device), censored=_censored(censored, dtype, device))

    def logpdf_link(self, link_f, y):
        c = _cens(self.censored, y)
        r = _bc(self.r, link_f)
        yr = torch.pow(y, r)
        uncensored = (1 - c) * (torch.log(r) - torch.log(link_f) + (r - 1) * torch.log(y)
                                - yr / link_f)
        return uncensored + c * (-yr / link_f)

    def conditional_mean(self, f):
        lam = self.gp_link.transf(f)
        return torch.pow(lam, 1.0 / self.r) * torch.exp(torch.lgamma(1.0 + 1.0 / self.r))

    def conditional_variance(self, f):
        lam = self.gp_link.transf(f)
        m1 = torch.exp(torch.lgamma(1.0 + 1.0 / self.r))
        m2 = torch.exp(torch.lgamma(1.0 + 2.0 / self.r))
        return torch.pow(lam, 2.0 / self.r) * (m2 - m1 ** 2)

    def samples(self, f, rng=None):
        # CDF(y) = 1 - exp(-y^r / lam): y = (lam E)^(1/r), E ~ Exp(1)
        lam = self.gp_link.transf(f)
        e = _host_draw(f, _rng(rng).exponential(size=tuple(f.shape)))
        return torch.pow(lam * e, 1.0 / self.r)


@dataclasses.dataclass(frozen=True)
class LogGaussian(LinkedLikelihood):
    """Log-normal observations, Identity link on the log-scale location by
    default (GPy loggaussian.py:13-60); censored: log(1 - Phi((log y - lam)/s))."""

    variance: torch.Tensor = None
    censored: torch.Tensor = None

    @classmethod
    def create(cls, variance=1.0, gp_link=None, censored=None, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(gp_link=gp_link if gp_link is not None else IdentityLink(),
                   variance=_scalar(variance, dtype, device),
                   censored=_censored(censored, dtype, device))

    def logpdf_link(self, link_f, y):
        c = _cens(self.censored, y)
        s2 = _bc(self.variance, link_f)
        z = (torch.log(y) - link_f) / torch.sqrt(s2)
        uncensored = (1 - c) * (-0.5 * torch.log(2 * math.pi * s2) - torch.log(y)
                                - 0.5 * torch.square(z))
        return uncensored + c * torch.special.log_ndtr(-z)

    def conditional_mean(self, f):
        return torch.exp(self.gp_link.transf(f) + self.variance / 2.0)

    def conditional_variance(self, f):
        lam = self.gp_link.transf(f)
        return torch.expm1(self.variance) * torch.exp(2 * lam + self.variance)

    def samples(self, f, rng=None):
        lam = self.gp_link.transf(f)
        z = _host_draw(f, _rng(rng).standard_normal(tuple(f.shape)))
        return torch.exp(lam + torch.sqrt(self.variance) * z)


@dataclasses.dataclass(frozen=True)
class LogLogistic(LinkedLikelihood):
    """Log-logistic (Fisk) survival likelihood, Log link by default (GPy
    loglogistic.py:14-90): log p = log r + (r-1) log y - r log lam
    - 2 log1p((y/lam)^r); censored: -log1p((y/lam)^r)."""

    r: torch.Tensor = None
    censored: torch.Tensor = None

    @classmethod
    def create(cls, r=1.0, gp_link=None, censored=None, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(gp_link=gp_link if gp_link is not None else LogLink(),
                   r=_scalar(r, dtype, device), censored=_censored(censored, dtype, device))

    def logpdf_link(self, link_f, y):
        c = _cens(self.censored, y)
        r = _bc(self.r, link_f)
        log_ratio_r = r * (torch.log(y) - torch.log(link_f))
        log1p_term = torch.log1p(torch.exp(torch.clamp(log_ratio_r, max=80.0)))
        uncensored = (1 - c) * (torch.log(r) + (r - 1) * torch.log(y)
                                - r * torch.log(link_f) - 2.0 * log1p_term)
        return uncensored + c * (-log1p_term)

    def conditional_mean(self, f):
        b = math.pi / self.r
        return self.gp_link.transf(f) * b / torch.sin(b)  # r > 1

    def conditional_variance(self, f):
        lam = self.gp_link.transf(f)
        b = math.pi / self.r
        return torch.square(lam) * (2 * b / torch.sin(2 * b) - torch.square(b / torch.sin(b)))

    def samples(self, f, rng=None):
        # CDF(y) = (y/lam)^r / (1 + (y/lam)^r): y = lam (u / (1 - u))^(1/r)
        lam = self.gp_link.transf(f)
        u = _host_draw(f, _rng(rng).uniform(1e-7, 1.0 - 1e-7, size=tuple(f.shape)))
        return lam * torch.pow(u / (1.0 - u), 1.0 / self.r)


@dataclasses.dataclass(frozen=True)
class MixedNoise(Likelihood):
    """Per-output Gaussian noise selected by an output index (GPy
    mixed_noise.py:14-60): row n uses ``variances[output_index[n]]``."""

    variances: torch.Tensor = None     # (num_outputs,)
    output_index: torch.Tensor = None  # (N,) int

    @classmethod
    def create(cls, variances, output_index, dtype=None, device=None):
        dtype, device = _new(dtype, device)
        return cls(variances=torch.as_tensor(variances, dtype=dtype, device=device).reshape(-1),
                   output_index=torch.as_tensor(np.asarray(output_index, dtype=np.int64),
                                                device=device).reshape(-1))

    def gaussian_variance(self):
        """(mixed_noise.py:23-30)"""
        return self.variances[self.output_index]

    def logpdf(self, f, y):
        v = self.gaussian_variance().reshape(f.shape)
        return -0.5 * (torch.log(2 * math.pi * v) + torch.square(y - f) / v)

    def dlogpdf_df(self, f, y):
        return (y - f) / self.gaussian_variance().reshape(f.shape)

    def d2logpdf_df2(self, f, y):
        return -1.0 / self.gaussian_variance().reshape(f.shape)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return self.gaussian_variance().reshape(f.shape)

    def predictive_values(self, mu, var):
        """(mixed_noise.py:45-52): adds the per-index noise variance."""
        return mu, var + self.gaussian_variance().reshape(mu.shape)

    def samples(self, f, rng=None):
        v = self.gaussian_variance().reshape((-1,) + (1,) * (f.ndim - 1))
        return f + torch.sqrt(v) * _host_draw(f, _rng(rng).standard_normal(tuple(f.shape)))


@dataclasses.dataclass(frozen=True)
class MultioutputLikelihood(Likelihood):
    """A per-output list of any likelihoods selected by an output index (GPy
    multioutput_likelihood.py:20): row n uses ``likelihoods[output_index[n]]``.
    Every sub-likelihood is evaluated on the whole arrays and the rows are
    selected (the reference's branchless form); the derivatives select the
    sub-likelihoods' own derivatives."""

    likelihoods: tuple = None
    output_index: torch.Tensor = None  # (N,) int

    @classmethod
    def create(cls, likelihoods, output_index, device=None):
        idx = np.asarray(output_index, dtype=np.int64).reshape(-1)
        if idx.size and (idx.min() < 0 or idx.max() >= len(likelihoods)):
            raise ValueError(
                f"output_index values must lie in [0, {len(likelihoods) - 1}]; "
                f"got range [{idx.min()}, {idx.max()}]")
        return cls(likelihoods=tuple(likelihoods),
                   output_index=torch.as_tensor(idx, device=resolve_device(device)))

    def _select(self, outs, like):
        idx = self.output_index.reshape((-1,) + (1,) * (like.ndim - 1))
        res = outs[0]
        for j in range(1, len(outs)):
            res = torch.where(idx == j, outs[j], res)
        return res

    def logpdf(self, f, y):
        return self._select([lk.logpdf(f, y) for lk in self.likelihoods], f)

    def dlogpdf_df(self, f, y):
        return self._select([lk.dlogpdf_df(f, y) for lk in self.likelihoods], f)

    def d2logpdf_df2(self, f, y):
        return self._select([lk.d2logpdf_df2(f, y) for lk in self.likelihoods], f)

    def conditional_mean(self, f):
        return self._select([lk.conditional_mean(f) for lk in self.likelihoods], f)

    def conditional_variance(self, f):
        return self._select([lk.conditional_variance(f) for lk in self.likelihoods], f)

    def samples(self, f, rng=None):
        """Every sub-likelihood samples the whole array, rows selected by index."""
        rng = _rng(rng)
        return self._select([lk.samples(f, rng) for lk in self.likelihoods], f)

    def gaussian_variance(self):
        """Per-row noise when every sub-likelihood is Gaussian
        (multioutput_likelihood.py:62-65)."""
        if not all(isinstance(lk, GaussianLik) for lk in self.likelihoods):
            raise TypeError("gaussian_variance requires all sub-likelihoods Gaussian "
                            "(use Laplace/EP inference for the general mix)")
        vs = torch.stack([lk.variance.reshape(()) for lk in self.likelihoods])
        return vs[self.output_index]

    def predictive_values(self, mu, var):
        """Row-wise predictive through each sub-likelihood
        (multioutput_likelihood.py:79-88)."""
        outs = []
        for lk in self.likelihoods:
            if hasattr(lk, "predictive_values"):
                outs.append(lk.predictive_values(mu, var))
            elif isinstance(lk, GaussianLik):
                outs.append((mu, var + lk.variance))
            else:
                outs.append(lk.predictive(mu, var))
        return (self._select([o[0] for o in outs], mu),
                self._select([o[1] for o in outs], var))

    def moments_match_ep(self, y, tau_cav, v_cav, gh_points=32):
        """Site-wise EP moments through the matching sub-likelihood
        (multioutput_likelihood.py:59-60); ``gh_points`` goes to the
        quadrature ones."""
        outs = []
        for lk in self.likelihoods:
            if "gh_points" in inspect.signature(lk.moments_match_ep).parameters:
                outs.append(lk.moments_match_ep(y, tau_cav, v_cav, gh_points=gh_points))
            else:
                outs.append(lk.moments_match_ep(y, tau_cav, v_cav))
        return tuple(self._select([o[k] for o in outs], y) for k in range(3))

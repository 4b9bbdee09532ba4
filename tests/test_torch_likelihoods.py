"""The torch port's likelihoods (``models/likelihoods.py``) against the JAX
package, in float64: one parametrised test per method over every likelihood,
and one over the seven links. Closed forms and autograd derivatives agree to
rel 1e-12; quantiles from the same (injected) observation draws agree to 1e-12;
the port's own draws hold their conditional mean within 5 standard errors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.models import likelihoods as jl
from gaussian_process_optimization_tpu_torch.models import likelihoods as tl
from torch_threads import one_torch_thread  # noqa: F401

N = 7
_R = np.random.default_rng(0)
F = _R.normal(size=N) * 0.7
VAR = _R.uniform(0.1, 0.5, N)
CENS = (_R.uniform(size=N) > 0.6).astype(float)
IDX = np.array([0, 1, 1, 0, 2, 1, 0])
POS = _R.exponential(size=N) + 0.1

# name -> (class name, create kwargs or None for a bare constructor, targets)
SPECS = {
    "Gaussian": ("GaussianLik", {"variance": 0.3}, _R.normal(size=N)),
    "Bernoulli": ("Bernoulli", None, (_R.uniform(size=N) > 0.5).astype(float)),
    "Poisson": ("Poisson", None, _R.poisson(2.0, size=N).astype(float)),
    "StudentT": ("StudentT", {"deg_free": 4.0, "sigma2": 0.5}, _R.normal(size=N)),
    "Binomial": ("Binomial", {"trials": np.full(N, 5.0)}, _R.integers(0, 6, N).astype(float)),
    "Gamma": ("GammaLik", {"beta": 2.0}, _R.gamma(2.0, size=N)),
    "Exponential": ("ExponentialLik", None, POS),
    "Heteroscedastic": ("HeteroscedasticGaussian", {"variances": VAR[::-1].copy()},
                        _R.normal(size=N)),
    "Weibull": ("Weibull", {"r": 1.5}, POS),
    "Weibull-censored": ("Weibull", {"r": 1.5, "censored": CENS}, POS),
    "LogGaussian": ("LogGaussian", {"variance": 0.4}, POS),
    "LogGaussian-censored": ("LogGaussian", {"variance": 0.4, "censored": CENS}, POS),
    "LogLogistic": ("LogLogistic", {"r": 2.5}, POS),
    "LogLogistic-censored": ("LogLogistic", {"r": 2.5, "censored": CENS}, POS),
    "MixedNoise": ("MixedNoise", {"variances": [0.2, 0.5, 0.3], "output_index": IDX},
                   _R.normal(size=N)),
    "Multioutput": ("MultioutputLikelihood", "multi", _R.poisson(2.0, size=N).astype(float)),
}
# The per-point variances (heteroscedastic, mixed noise) are reshaped to f's
# shape and the censoring flags broadcast against y: neither takes the
# quadrature axis in the reference, so these are not held there.
NO_QUADRATURE = {"Heteroscedastic", "MixedNoise", "Weibull-censored", "LogGaussian-censored",
                 "LogLogistic-censored"}
ALL = list(SPECS)
QUADRATURE = [k for k in ALL if k not in NO_QUADRATURE]


def _make(key):
    cls, kw, y = SPECS[key]
    if kw == "multi":
        jparts = [jl.GaussianLik.create(0.3), jl.Poisson(), jl.StudentT.create(4.0, 0.5)]
        tparts = [tl.GaussianLik.create(0.3, device="cpu"), tl.Poisson(),
                  tl.StudentT.create(4.0, 0.5, device="cpu")]
        return (jl.MultioutputLikelihood.create(jparts, IDX),
                tl.MultioutputLikelihood.create(tparts, IDX, device="cpu"), y)
    if kw is None:
        return getattr(jl, cls)(), getattr(tl, cls)(), y
    return getattr(jl, cls).create(**kw), getattr(tl, cls).create(**kw, device="cpu"), y


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=float))


def _close(got, want, rtol=1e-12):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("key", ALL)
@pytest.mark.parametrize("method", ["logpdf", "dlogpdf_df", "d2logpdf_df2"])
def test_logpdf_and_derivatives_match_jax(key, method):
    jlik, tlik, y = _make(key)
    _close(getattr(tlik, method)(_t(F), _t(y)), getattr(jlik, method)(jnp.asarray(F),
                                                                       jnp.asarray(y)))


@pytest.mark.parametrize("key", ["StudentT", "Gamma", "Weibull", "LogLogistic"])
def test_third_derivative_matches_jax(key):
    """Laplace's gradient differentiates ``d2logpdf_df2`` once more: the port's
    (autograd with the graph kept) against ``jax.grad`` of the reference's."""
    jlik, tlik, y = _make(key)
    f = _t(F).requires_grad_(True)
    (g,) = torch.autograd.grad(tlik.d2logpdf_df2(f, _t(y)).sum(), f)
    want = jax.grad(lambda ff: jnp.sum(jlik.d2logpdf_df2(ff, jnp.asarray(y))))(jnp.asarray(F))
    _close(g, want, rtol=1e-10)


@pytest.mark.parametrize("key", QUADRATURE)
@pytest.mark.parametrize("method", ["predictive", "log_predictive_density", "moments_match_ep"])
def test_quadrature_methods_match_jax(key, method):
    jlik, tlik, y = _make(key)
    if method == "predictive":
        got, want = tlik.predictive(_t(F), _t(VAR)), jlik.predictive(jnp.asarray(F),
                                                                     jnp.asarray(VAR))
    elif method == "log_predictive_density":
        got = tlik.log_predictive_density(_t(y), _t(F), _t(VAR))
        want = jlik.log_predictive_density(jnp.asarray(y), jnp.asarray(F), jnp.asarray(VAR))
    else:
        tau, v = 1.0 / VAR, F / VAR
        got = tlik.moments_match_ep(_t(y), _t(tau), _t(v))
        want = jlik.moments_match_ep(jnp.asarray(y), jnp.asarray(tau), jnp.asarray(v))
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(a, b, rtol=1e-11)


@pytest.mark.parametrize("key", ALL)
def test_predictive_quantiles_match_jax(key):
    """The Gaussian's closed form; every other likelihood's sampling fallback
    on the JAX package's own observation draws, injected."""
    jlik, tlik, _ = _make(key)
    q = (5.0, 50.0, 95.0)
    key0 = jax.random.PRNGKey(3)
    want = jlik.predictive_quantiles(jnp.asarray(F), jnp.asarray(VAR), q, key=key0,
                                     n_samples=64)
    draws = None
    if key != "Gaussian":
        kf, ky = jax.random.split(key0)
        f = jnp.asarray(F)[:, None] + jnp.sqrt(jnp.asarray(VAR))[:, None] * jax.random.normal(
            kf, (N, 64), dtype=jnp.float64)
        draws = np.asarray(jlik.samples(f, ky))
    got = tlik.predictive_quantiles(_t(F), _t(VAR), q, draws=draws)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("key", ALL)
def test_samples_hold_the_conditional_mean(key):
    """The port's observation draws (numpy on the host) at fixed f: their mean
    within 5 standard errors of the reference's conditional mean, every row."""
    jlik, tlik, _ = _make(key)
    S = 4000
    f = np.tile(F[:, None], (1, S))
    y = tlik.samples(_t(f), np.random.default_rng(7)).numpy()
    assert y.shape == (N, S) and np.isfinite(y).all()
    mean = np.asarray(jlik.conditional_mean(jnp.asarray(F)[:, None]))[:, 0]
    sd = np.sqrt(np.asarray(jlik.conditional_variance(jnp.asarray(F)[:, None]))[:, 0])
    assert np.all(np.abs(y.mean(1) - mean) <= 5 * sd / np.sqrt(S) + 1e-12), (y.mean(1), mean)


LINKS = ["IdentityLink", "LogLink", "ProbitLink", "LogExp1Link", "ReciprocalLink",
         "CloglogLink", "HeavisideLink"]


@pytest.mark.parametrize("link", LINKS)
def test_links_match_jax(link):
    """``transf`` and ``dtransf_df`` of every link, and a Weibull through it."""
    jlink, tlink = getattr(jl, link)(), getattr(tl, link)()
    _close(tlink.transf(_t(F)), jlink.transf(jnp.asarray(F)))
    _close(tlink.dtransf_df(_t(F)), jlink.dtransf_df(jnp.asarray(F)))
    if link in ("LogLink", "LogExp1Link", "CloglogLink"):
        jw = jl.Weibull.create(1.5, gp_link=jlink)
        tw = tl.Weibull.create(1.5, gp_link=tlink, device="cpu")
        _close(tw.logpdf(_t(F), _t(POS)), jw.logpdf(jnp.asarray(F), jnp.asarray(POS)))


def test_lane_parameters_broadcast():
    """A scalar parameter with a lane axis (the Fitter's restarts) gives each
    lane the value of its own unbatched likelihood."""
    t = tl.StudentT(deg_free=torch.tensor([3.0, 6.0], dtype=torch.float64),
                    sigma2=torch.tensor([0.5, 0.2], dtype=torch.float64))
    f = _t(np.stack([F, -F]))
    y = _t(SPECS["StudentT"][2])
    for method in ("logpdf", "dlogpdf_df", "d2logpdf_df2"):
        out = getattr(t, method)(f, y)
        for b in range(2):
            one = tl.StudentT(deg_free=t.deg_free[b], sigma2=t.sigma2[b])
            _close(out[b], getattr(one, method)(f[b], y), rtol=1e-14)


def test_multioutput_rejects_an_index_out_of_range():
    with pytest.raises(ValueError):
        tl.MultioutputLikelihood.create([tl.Poisson()], [0, 1], device="cpu")

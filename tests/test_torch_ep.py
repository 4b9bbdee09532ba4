"""The torch port's expectation propagation (``models/ep.py``) against the JAX
package, in float64: dense EP in both modes (probit and a quadrature
likelihood), its evidence, the probit wrapper and the prediction; EPDTC in both
modes, its evidence at fixed sites and that evidence's gradient; EPDTC with
Z = X against dense EP. Sites, posteriors and evidences agree to rel 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import ep as jep
from gaussian_process_optimization_tpu.models import likelihoods as jl
from gaussian_process_optimization_tpu_torch.models import ep as tep
from gaussian_process_optimization_tpu_torch.models import likelihoods as tl
from torch_threads import one_torch_thread  # noqa: F401

N, M = 18, 6
_R = np.random.default_rng(0)
X = _R.uniform(-2, 2, (N, 2))
Y_CLASS = np.where(np.sin(2 * X[:, 0]) + 0.3 * _R.standard_normal(N) > 0, 1.0, -1.0)
Y_COUNT = _R.poisson(np.exp(0.5 * np.cos(X[:, 1]))).astype(float)
Z = X[_R.permutation(N)[:M]]
XS = _R.uniform(-2.5, 2.5, (5, 2))
KERN = jk.RBF.create(2, variance=1.5, lengthscale=0.8)


def _k(a, b=None):
    return np.asarray(KERN.K(jnp.asarray(a), None if b is None else jnp.asarray(b)))


K, KS, KSS = _k(X), _k(X, XS), np.full(5, 1.5)
KMM, KMN, KMS = _k(Z) + 1e-8 * np.eye(M), _k(Z, X), _k(Z, XS)
LIKS = {"probit": (jl.Bernoulli(), tl.Bernoulli(), Y_CLASS),
        "poisson": (jl.Poisson(), tl.Poisson(), Y_COUNT)}


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=float))


def _close(got, want, rtol=1e-8):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("lik", list(LIKS))
def test_dense_ep_matches_jax(mode, lik):
    jlik, tlik, y = LIKS[lik]
    jp = jep.ep_inference(jnp.asarray(K), jnp.asarray(y), jlik, mode=mode)
    tp = tep.ep_inference(_t(K), _t(y), tlik, mode=mode)
    for name in ("tau_site", "nu_site", "mu", "Sigma", "lml"):
        _close(getattr(tp, name), getattr(jp, name))
    assert 2 <= tp.sweeps < 50 and tp.site_change < 1e-6
    mu, var = tep.ep_predict(_t(K), _t(KS), _t(KSS), tp)
    jmu, jvar = jep.ep_predict(jnp.asarray(K), jnp.asarray(KS), jnp.asarray(KSS), jp)
    _close(mu, jmu)
    _close(var, jvar)


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_probit_wrapper_matches_jax(mode):
    jp = jep.ep_probit_inference(jnp.asarray(K), jnp.asarray(Y_CLASS), sweeps=12, mode=mode)
    tp = tep.ep_probit_inference(_t(K), _t(Y_CLASS), sweeps=12, mode=mode)
    for name in ("tau_site", "nu_site", "lml"):
        _close(getattr(tp, name), getattr(jp, name))


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_epdtc_matches_jax(mode):
    jp = jep.epdtc_inference(jnp.asarray(KMM), jnp.asarray(KMN), jnp.full(N, 1.5),
                             jnp.asarray(Y_CLASS), jl.Bernoulli(), mode=mode)
    tp = tep.epdtc_inference(_t(KMM), _t(KMN), _t(np.full(N, 1.5)), _t(Y_CLASS),
                             tl.Bernoulli(), mode=mode)
    for name in ("tau_site", "nu_site", "Lm", "LB", "c", "lml"):
        _close(getattr(tp, name), getattr(jp, name))
    mu, var = tep.epdtc_predict(tp.Lm, tp.LB, tp.c, _t(KMS), _t(KSS))
    jmu, jvar = jep.epdtc_predict(jp.Lm, jp.LB, jp.c, jnp.asarray(KMS), jnp.asarray(KSS))
    _close(mu, jmu)
    _close(var, jvar)


def test_epdtc_site_fixed_evidence_and_gradient_match_jax():
    """The bound at fixed sites, and its gradient in Kmm, Kmn and Kdiag (what
    the alternated optimizer differentiates), rel 1e-8."""
    jp = jep.epdtc_inference(jnp.asarray(KMM), jnp.asarray(KMN), jnp.full(N, 1.5),
                             jnp.asarray(Y_CLASS), jl.Bernoulli())
    sites = (jp.tau_site, jp.nu_site)

    def jlml(a, b, c):
        return jep.epdtc_inference(a, b, c, jnp.asarray(Y_CLASS), jl.Bernoulli(),
                                   sites=sites).lml

    args = (jnp.asarray(KMM), jnp.asarray(KMN), jnp.full(N, 1.5))
    jval, jgrads = jax.value_and_grad(jlml, argnums=(0, 1, 2))(*args)
    targs = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    tval = tep.epdtc_inference(*targs, _t(Y_CLASS), tl.Bernoulli(),
                               sites=tuple(_t(s) for s in sites)).lml
    grads = torch.autograd.grad(tval, targs)
    assert float(tval) == pytest.approx(float(jval), rel=1e-10)
    for g, w in zip(grads, jgrads):
        _close(g, w)


def test_epdtc_with_every_input_inducing_is_dense_ep():
    """Z = X: the DTC posterior is the dense one, so the sites agree with
    dense EP's (rel 1e-5) and the predictions too."""
    Kj = K + 1e-8 * np.eye(N)
    dense = tep.ep_inference(_t(Kj), _t(Y_CLASS), tl.Bernoulli())
    sparse = tep.epdtc_inference(_t(Kj), _t(Kj), _t(np.full(N, 1.5)), _t(Y_CLASS),
                                 tl.Bernoulli())
    _close(sparse.tau_site, dense.tau_site.numpy(), rtol=1e-5)
    _close(sparse.nu_site, dense.nu_site.numpy(), rtol=1e-5)
    mu_d, _ = tep.ep_predict(_t(Kj), _t(KS), _t(KSS), dense)
    mu_s, _ = tep.epdtc_predict(sparse.Lm, sparse.LB, sparse.c, _t(KS), _t(KSS))
    _close(mu_s, mu_d.numpy(), rtol=1e-4)

"""The torch port's Student-t process (``models/tp.py``) and KL variational
Gaussian inference (``models/var_gauss.py``) against the JAX package, in
float64: the TP evidence and its gradient at two lanes (rel 1e-10 / 1e-8), its
prediction and quantiles, a short fit, and the convert helper; the variational
ELBO and its gradient, a short L-BFGS run and the prediction."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import likelihoods as jl
from gaussian_process_optimization_tpu.models import var_gauss as jvg
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.models.tp import TPRegression as JTP
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF, Matern52
from gaussian_process_optimization_tpu_torch.models import fit as tfit
from gaussian_process_optimization_tpu_torch.models import likelihoods as tl
from gaussian_process_optimization_tpu_torch.models import var_gauss as tvg
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.models.tp import TPRegression
from torch_threads import one_torch_thread  # noqa: F401

_R = np.random.default_rng(2)
X = _R.uniform(-2, 2, (22, 2))
Y = np.sin(X[:, :1]) * np.cos(X[:, 1:]) + 0.05 * _R.standard_normal((22, 1))
Y[::7] += 2.0  # outliers
XS = _R.uniform(-2.5, 2.5, (7, 2))


def _tp():
    ls = np.array([0.8, 1.2])
    jm = JTP.create(X, Y, kernel=jk.Matern52.create(2, variance=0.7, lengthscale=ls, ARD=True),
                    deg_free=5.0)
    tm = TPRegression.create(X, Y, kernel=Matern52.create(2, variance=0.7, lengthscale=ls,
                                                          ARD=True, device="cpu"),
                             deg_free=5.0, device="cpu")
    return jm, tm


def test_tp_evidence_and_gradient_match_jax():
    jm, tm = _tp()
    jp, tp = jmake_packer(jm), make_packer(tm)
    assert tp.num_free == jp.num_free and tp.fixed == jp.fixed
    jobj, tobj = jfit.make_objective(jp), tfit.make_objective(tp)
    u0 = np.asarray(jp.pack(jm))
    U = np.stack([u0, u0 + 0.1 * np.sin(np.arange(u0.shape[0]) + 1.0)])
    Ut = torch.tensor(U, requires_grad=True)
    f = tobj(Ut, tm)
    (g,) = torch.autograd.grad(f.sum(), Ut)
    for b in range(2):
        val, grad = jax.value_and_grad(jobj)(jnp.asarray(U[b]), jm)
        assert float(f[b]) == pytest.approx(float(val), rel=1e-10)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(grad), rtol=1e-8,
                                   atol=1e-10 * np.abs(np.asarray(grad)).max())


@pytest.mark.parametrize("full_cov", [False, True])
def test_tp_prediction_matches_jax(full_cov):
    jm, tm = _tp()
    with torch.no_grad():
        got = tm.predict(XS, full_cov=full_cov)
    for a, b in zip(got, jm.predict(jnp.asarray(XS), full_cov=full_cov)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)
    if not full_cov:
        with torch.no_grad():
            q = tm.predict_quantiles(XS, (2.5, 50.0, 97.5))
        for a, b in zip(q, jm.predict_quantiles(jnp.asarray(XS), (2.5, 50.0, 97.5))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_tp_fit_and_convert_match_jax():
    """One restart of 8 L-BFGS steps (the fitted evidence rel 1e-6); the JAX
    model's leaves carried across by ``convert.tp_from_leaves``."""
    jm, tm = _tp()
    jfitted, _ = jfit.fit(jm, num_restarts=1, maxiter=8, key=jax.random.PRNGKey(0))
    tfitted, _ = tfit.fit(tm, num_restarts=1, maxiter=8)
    with torch.no_grad():
        t_lml = float(tfitted.log_marginal_likelihood())
    assert t_lml == pytest.approx(float(jfitted.log_marginal_likelihood()), rel=1e-6)
    leaves = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
              "deg_free": jm.deg_free, "X": jm.X, "Y": jm.Y}
    back = convert.tp_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                  family="matern52", device="cpu")
    with torch.no_grad():
        assert float(back.log_marginal_likelihood()) == pytest.approx(
            float(jm.log_marginal_likelihood()), rel=1e-12)


def _vg():
    k = RBF.create(2, variance=2.0, lengthscale=0.9, device="cpu")
    K = k.K(torch.as_tensor(X)).detach()
    y = (Y[:, 0] > np.median(Y)).astype(float)
    return K, y, k


def test_vargauss_elbo_and_gradient_match_jax():
    K, y, _ = _vg()
    n = K.shape[0]
    a0 = 0.1 * np.cos(np.arange(n))
    w0 = 0.5 + 0.1 * np.sin(np.arange(n))

    def jelbo(a, w):
        return jvg.vargauss_elbo(jnp.asarray(K.numpy()), jnp.asarray(y), jl.Bernoulli(), a, w)

    jval, jgrads = jax.value_and_grad(jelbo, argnums=(0, 1))(jnp.asarray(a0), jnp.asarray(w0))
    a, w = torch.tensor(a0, requires_grad=True), torch.tensor(w0, requires_grad=True)
    val = tvg.vargauss_elbo(K, torch.as_tensor(y), tl.Bernoulli(), a, w)
    grads = torch.autograd.grad(val, (a, w))
    assert float(val) == pytest.approx(float(jval), rel=1e-11)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)


def test_vargauss_inference_and_prediction_match_jax():
    """10 L-BFGS steps from zeros: the ELBO rel 1e-8; then the prediction."""
    K, y, k = _vg()
    jp = jvg.vargauss_inference(jnp.asarray(K.numpy()), jnp.asarray(y), jl.Bernoulli(),
                                maxiter=10)
    tp = tvg.vargauss_inference(K, torch.as_tensor(y), tl.Bernoulli(), maxiter=10)
    assert float(tp.elbo) == pytest.approx(float(jp.elbo), rel=1e-8)
    Ks = k.K(torch.as_tensor(X), torch.as_tensor(XS)).detach()
    kss = k.Kdiag(torch.as_tensor(XS))
    with torch.no_grad():
        mu, var = tvg.vargauss_predict(K, Ks, kss, tp)
    jmu, jvar = jvg.vargauss_predict(jnp.asarray(K.numpy()), jnp.asarray(Ks.numpy()),
                                     jnp.asarray(kss.numpy()), jp)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-6, atol=1e-8)

"""The torch port's classifiers (``models/classification.py``, ``models/gplvm.py``'s
psi statistics, ``utils/classification.py``) against the JAX package, in
float64: the EP evidence and the class probabilities of the dense, sparse and
uncertain-input classifiers (rel 1e-8), one round of the alternated optimizer
(the fitted evidence rel 1e-6), the site-fixed evidence's gradient, the RBF psi
statistics, ``conf_matrix`` and ``convert.classification_from_leaves``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import classification as jc
from gaussian_process_optimization_tpu.models.gplvm import rbf_psi_stats_n as jpsi
from gaussian_process_optimization_tpu.utils.classification import conf_matrix as jconf
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF
from gaussian_process_optimization_tpu_torch.models import classification as tc
from gaussian_process_optimization_tpu_torch.models.gplvm import rbf_psi_stats_n as tpsi
from gaussian_process_optimization_tpu_torch.utils.classification import conf_matrix
from torch_threads import one_torch_thread  # noqa: F401

N = 20
_R = np.random.default_rng(1)
X = _R.uniform(-2, 2, (N, 2))
Y = (np.sin(2 * X[:, 0]) + X[:, 1] + 0.3 * _R.standard_normal(N) > 0).astype(float)
S = _R.uniform(0.01, 0.1, (N, 2))
XS = _R.uniform(-2.5, 2.5, (6, 2))


def _kerns():
    return (jk.RBF.create(2, variance=1.2, lengthscale=np.array([0.8, 1.1]), ARD=True),
            RBF.create(2, variance=1.2, lengthscale=np.array([0.8, 1.1]), ARD=True,
                       device="cpu"))


def _models(kind):
    jkern, tkern = _kerns()
    if kind == "dense":
        return (jc.GPClassification.create(X, Y, kernel=jkern),
                tc.GPClassification.create(X, Y, kernel=tkern, device="cpu"))
    if kind == "sparse":
        return (jc.SparseGPClassification.create(X, Y, kernel=jkern, num_inducing=7),
                tc.SparseGPClassification.create(X, Y, kernel=tkern, num_inducing=7,
                                                 device="cpu"))
    return (jc.SparseGPClassificationUncertainInput.create(X, S, Y, kernel=jkern,
                                                           num_inducing=7),
            tc.SparseGPClassificationUncertainInput.create(X, S, Y, kernel=tkern,
                                                           num_inducing=7, device="cpu"))


KINDS = ["dense", "sparse", "uncertain"]


@pytest.fixture(scope="module", params=KINDS)
def models(request):
    return request.param, _models(request.param)


def test_evidence_and_prediction_match_jax(models):
    _, (jm, tm) = models
    if hasattr(jm, "Z"):
        np.testing.assert_array_equal(tm.Z.numpy(), np.asarray(jm.Z))
    assert float(tm.log_marginal_likelihood()) == pytest.approx(
        float(jm.log_marginal_likelihood()), rel=1e-8)
    np.testing.assert_allclose(tm.predict(XS).numpy(), np.asarray(jm.predict(jnp.asarray(XS))),
                               rtol=1e-8, atol=1e-10)


def test_site_fixed_gradient_matches_jax(models):
    """The gradient of the evidence at the converged sites in the packed
    parameters (the kernel, and Z for the sparse models), rel 1e-7."""
    from gaussian_process_optimization_tpu.models.ep import (_dense_ep_lml,
                                                            _dense_posterior_from_sites)
    from gaussian_process_optimization_tpu.models.likelihoods import Bernoulli
    from gaussian_process_optimization_tpu.models.parameters import make_packer as jmp
    from gaussian_process_optimization_tpu_torch.models.parameters import make_packer

    kind, (jm, tm) = models
    fix = ("X_variance",) if kind == "uncertain" else ()
    jpost = jm.inference()
    tau, nu = jpost.tau_site, jpost.nu_site
    jp, tp = jmp(jm, fix=fix), make_packer(tm, fix=fix)
    assert jp.num_free == tp.num_free

    def jlml(u):
        m = jp.unpack(u, reference=jm)
        if kind == "dense":
            K = m.kern.K(m.X)
            mu, Sigma, L, _ = _dense_posterior_from_sites(K, tau, nu)
            return _dense_ep_lml(Bernoulli(), m.Y, K, tau, nu, mu, Sigma, L, 1.0)
        return m._site_fixed_lml(tau, nu)

    u0 = jp.pack(jm)
    jval, jgrad = jax.value_and_grad(jlml)(u0)
    u = torch.tensor(np.asarray(u0), requires_grad=True)
    tval = tp.unpack(u, reference=tm).site_fixed_lml(torch.as_tensor(np.asarray(tau)),
                                                     torch.as_tensor(np.asarray(nu)))
    (g,) = torch.autograd.grad(tval, u)
    assert float(tval) == pytest.approx(float(jval), rel=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(jgrad), rtol=1e-7,
                               atol=1e-9 * np.abs(np.asarray(jgrad)).max())


@pytest.mark.parametrize("kind", KINDS)
def test_alternated_optimize_matches_jax(kind):
    """One round of 6 L-BFGS steps at fixed sites: the fitted evidence rel
    1e-6, and above the start."""
    jm, tm = _models(kind)
    jfit, _ = jm.optimize(rounds=1, maxiter=6)
    tfit, res = tm.optimize(rounds=1, maxiter=6)
    t_lml = float(tfit.log_marginal_likelihood())
    assert t_lml == pytest.approx(float(jfit.log_marginal_likelihood()), rel=1e-6)
    assert t_lml > float(tm.log_marginal_likelihood())
    if kind == "uncertain":
        assert torch.equal(tfit.X_variance, tm.X_variance)


def test_psi_statistics_match_jax():
    jkern, tkern = _kerns()
    Z = X[:5]
    for a, b in zip(tpsi(tkern, torch.as_tensor(Z), torch.as_tensor(X), torch.as_tensor(S)),
                    jpsi(jkern, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(S))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-14)


def test_conf_matrix_matches_jax():
    p = np.random.default_rng(3).uniform(size=30)
    labels = (np.random.default_rng(4).uniform(size=30) > 0.5).astype(float)
    assert conf_matrix(torch.as_tensor(p), labels, show=False) == jconf(p, labels, show=False)
    with pytest.raises(ValueError):
        conf_matrix(p, labels[:5], show=False)


def test_convert_rebuilds_the_jax_models():
    for kind in ("dense", "sparse"):
        jm, _ = _models(kind)
        leaves = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
                  "X": jm.X, "Y": jm.Y}
        if kind == "sparse":
            leaves["Z"] = jm.Z
        back = convert.classification_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                                  device="cpu")
        assert float(back.log_marginal_likelihood()) == pytest.approx(
            float(jm.log_marginal_likelihood()), rel=1e-10)

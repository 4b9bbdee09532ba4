"""The torch port's ``models/zoo.py`` against the JAX package's, float64: the
heteroscedastic and Kronecker regressions (LML, gradient, predictions), the
variational Gaussian approximation (its ELBO after the inner L-BFGS, and the
latent prediction), the one-vs-all classifiers (probabilities and labels), the
back-constrained GPLVM with an MLP and a kernel mapping, the sparse GPLVM
and the offset regression (fits of 15 L-BFGS steps). Each tolerance is stated
where it is used; the sizes are the gallery's."""
import jax.numpy as jnp
import numpy as np
import pytest

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import zoo as jzoo
from gaussian_process_optimization_tpu.models.mean_functions import KernelMapping as JKM
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF
from gaussian_process_optimization_tpu_torch.models import zoo as tzoo
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.mean_functions import KernelMapping as TKM
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves
from test_torch_gplvm import (RTOL, Y_OIL, _np, _t, jax_leaves, port_latent,
                              value_and_grad_both)
from torch_threads import one_torch_thread  # noqa: F401

_R = np.random.default_rng(21)
X = _R.uniform(-2, 2, (40, 2))
Yr = np.sin(2 * X[:, :1]) * np.cos(X[:, 1:]) + 0.1 * _R.standard_normal((40, 1))
LABELS = (Yr[:, 0] > -0.3).astype(int) + (Yr[:, 0] > 0.3)
XS = _R.uniform(-2, 2, (6, 2))
_T = np.linspace(0, 2 * np.pi, 36)
Y_STICK = np.stack([np.sin(2 * _T + p) for p in _R.uniform(0, np.pi, 8)], 1)


def _grad_parity(jm, tm, fix=()):
    jpk, tpk = jmake_packer(jm, fix=fix), make_packer(tm, fix=fix)
    u = np.asarray(jpk.pack(jm)) + 0.05 * np.cos(np.arange(jpk.num_free))
    fj, gj, ft, gt = value_and_grad_both(jfit.make_objective(jpk), jpk, jm, make_objective(tpk),
                                         tpk, tm, u=u)
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-9 * np.abs(gj).max())


def _close_leaves(tm, jm, tol):
    got = dict(named_leaves(tm))
    for path, leaf in jax_leaves(jm, "").items():
        np.testing.assert_allclose(_np(got[path]), leaf, atol=tol * max(np.abs(leaf).max(), 1))


def test_heteroscedastic_regression_matches_jax():
    noise = np.linspace(0.05, 0.2, 40)
    jm = jzoo.GPHeteroscedasticRegression(X, Yr, noise_vars=noise)
    tm = tzoo.GPHeteroscedasticRegression(X, Yr, noise_vars=noise, device="cpu")
    assert tm.heteroscedastic and tm.likelihood_variance.shape == (40,)
    _grad_parity(jm, tm)
    for a, b in zip(jm.predict(jnp.asarray(XS), noise_at_test=0.1),
                    tm.predict(_t(XS), noise_at_test=0.1)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-10)


def test_kronecker_regression_matches_jax():
    g1, g2 = np.linspace(0, 1, 6)[:, None], np.linspace(0, 1, 5)[:, None]
    Yg = np.sin(3 * g1) @ np.cos(2 * g2).T
    jm = jzoo.GPKroneckerGaussianRegression(g1, g2, Yg, jk.RBF.create(1, lengthscale=0.4),
                                            jk.RBF.create(1), noise_var=0.1)
    tm = tzoo.GPKroneckerGaussianRegression(g1, g2, Yg, RBF.create(1, lengthscale=0.4,
                                                                  device="cpu"),
                                            RBF.create(1, device="cpu"), noise_var=0.1,
                                            device="cpu")
    _grad_parity(jm, tm, fix=("axes",))
    Xs = np.column_stack([np.linspace(0, 1, 4), np.linspace(1, 0, 4)])
    for a, b in zip(jm.predict(jnp.asarray(Xs)), tm.predict(_t(Xs))):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-9, atol=1e-12)


def test_variational_gaussian_approximation_matches_jax():
    """The ELBO after the inner L-BFGS (rtol 1e-8) and the latent prediction."""
    jm = jzoo.GPVariationalGaussianApproximation.create(X[:20], Yr[:20, 0])
    tm = tzoo.GPVariationalGaussianApproximation.create(X[:20], Yr[:20, 0], device="cpu")
    jpost, tpost = jm.inference(maxiter=50), tm.inference(maxiter=50)
    np.testing.assert_allclose(float(tpost.elbo), float(jpost.elbo), rtol=1e-8)
    for a, b in zip(jm.predict_latent(jnp.asarray(XS), posterior=jpost),
                    tm.predict_latent(_t(XS), posterior=tpost)):
        np.testing.assert_allclose(_np(b).reshape(-1), np.asarray(a).reshape(-1), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_one_vs_all_matches_jax(sparse):
    """Per-class probabilities within 1e-7 and the same labels."""
    if sparse:
        jm = jzoo.OneVsAllSparseClassification(X, LABELS, num_inducing=8)
        tm = tzoo.OneVsAllSparseClassification(X, LABELS, num_inducing=8, device="cpu")
    else:
        jm = jzoo.OneVsAllClassification(X, LABELS)
        tm = tzoo.OneVsAllClassification(X, LABELS, device="cpu")
    np.testing.assert_array_equal(tm.classes_, jm.classes_)
    np.testing.assert_allclose(tm.predict_proba(XS), jm.predict_proba(jnp.asarray(XS)),
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(tm.predict(XS), jm.predict(jnp.asarray(XS)))


@pytest.mark.parametrize("mapping", ["mlp", "kernel"])
def test_bcgplvm_matches_jax(mapping):
    """L-BFGS over the mapping, the kernel and the noise (15 steps; 10 with
    the kernel mapping, whose noise heads for its floor and whose -LML passes
    -1.8e3 by then): the objective within 1e-8, the latents within 1e-5 of
    their scale."""
    kw, tkw = {}, {}
    steps = 15
    if mapping == "kernel":
        kw["mapping"] = JKM.create(8, 2, Z=Y_STICK, kernel=jk.RBF.create(8))
        tkw["mapping"] = TKM.create(8, 2, Z=Y_STICK, kernel=RBF.create(8, device="cpu"),
                                    device="cpu")
        steps = 10
    jgp, jmap, jres = jzoo.fit_bcgplvm(Y_STICK, 2, maxiter=steps, **kw)
    tgp, tmap, tres = tzoo.fit_bcgplvm(Y_STICK, 2, maxiter=steps, device="cpu", **tkw)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-8)
    np.testing.assert_allclose(tgp.X.numpy(), np.asarray(jgp.X),
                               atol=1e-5 * np.abs(np.asarray(jgp.X)).max())
    _close_leaves(tmap, jmap, 1e-5)


def test_sparse_gplvm_matches_jax():
    jm, jres = jzoo.fit_sparse_gplvm(Y_OIL, 2, num_inducing=6, maxiter=15)
    tm, tres = tzoo.fit_sparse_gplvm(Y_OIL, 2, num_inducing=6, maxiter=15, device="cpu")
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-8)
    _close_leaves(tm, jm, 1e-5)


def test_offset_regression_matches_jax():
    """The converter's twin, the LML and its gradient (the offsets'
    included), 15 L-BFGS steps and a prediction in cluster 1."""
    Xo = np.column_stack([np.linspace(0, 5, 30), np.arange(30) % 3])
    Yo = np.sin(Xo[:, 0] + 0.3 * Xo[:, 1])
    jm = jzoo.GPOffsetRegression.create(Xo, Yo)
    tm = tzoo.GPOffsetRegression.create(Xo, Yo, device="cpu")
    conv = port_latent("GPOffsetRegression", jm)
    _close_leaves(conv, jm, 0.0)
    _grad_parity(jm, tm, fix=("sel",))
    jf, jres = jm.optimize(maxiter=15)
    tf, tres = tm.optimize(maxiter=15)
    np.testing.assert_allclose(float(tres.f), float(jres.f), rtol=1e-8)
    _close_leaves(tf, jf, 1e-5)
    for a, b in zip(jf.predict(jnp.asarray(Xo[:5, :1]), cluster=1),
                    tf.predict(_t(Xo[:5, :1]), cluster=1)):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5, atol=1e-7)

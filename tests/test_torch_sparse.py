"""The torch port's sparse GP (``models/sparse.py``, ``models/sparse_bo_model.py``)
against the JAX package, in float64: the VarDTC, DTC, FITC and PEP bounds and
their gradients in the packed parameters (Z included), on padded data and with
a lane axis; prediction, quantiles and predictive gradients; the missing-data
bound; the inducing-point initialization; and the BO wrapper's refit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import sparse as jsparse
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.models.sparse_bo_model import SparseGPModel as JSparseModel
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF, Matern52
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.models.sparse import SparseGPRegression, kmm_init
from gaussian_process_optimization_tpu_torch.models.sparse_bo_model import SparseGPModel
from gaussian_process_optimization_tpu_torch.utils.tree import tree_map


def _data(n=26, d=2, p=1, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d))
    Y = np.sin(2 * X[:, :1]) * np.cos(X[:, 1:2]) + 0.05 * rng.standard_normal((n, 1))
    return X, np.hstack([Y + 0.3 * j for j in range(p)])


def _pair(inference, normalizer=False, p=1, kernel="rbf"):
    X, Y = _data(p=p)
    if kernel == "rbf":
        jkern, tkern = jk.RBF.create(2, lengthscale=0.9), RBF.create(2, lengthscale=0.9,
                                                                     device="cpu")
    else:
        ls = np.array([0.7, 1.2])
        jkern = jk.Matern52.create(2, lengthscale=ls, ARD=True)
        tkern = Matern52.create(2, lengthscale=ls, ARD=True, device="cpu")
    kw = dict(num_inducing=7, noise_var=0.05, inference=inference, max_points=32,
              normalizer=normalizer)
    return (jsparse.SparseGPRegression.create(X, Y, kernel=jkern, **kw),
            SparseGPRegression.create(X, Y, kernel=tkern, device="cpu", **kw))


CASES = [("vardtc", False, "rbf"), ("dtc", False, "rbf"), ("fitc", False, "matern52"),
         ("pep", True, "matern52")]


@pytest.mark.parametrize("inference,normalizer,kernel", CASES)
def test_bound_and_gradient_match_jax(inference, normalizer, kernel):
    """The bound at two lanes of packed parameters, rel 1e-10, and its
    gradient, Z's rows included, rel 1e-8."""
    jm, tm = _pair(inference, normalizer, kernel=kernel)
    np.testing.assert_array_equal(tm.Z.numpy(), np.asarray(jm.Z))
    jp, tp = jmake_packer(jm), make_packer(tm)
    assert tp.num_free == jp.num_free and tp.fixed == jp.fixed
    jobj, tobj = jfit.make_objective(jp), make_objective(tp)
    u0 = np.asarray(jp.pack(jm))
    U = np.stack([u0, u0 + 0.05 * np.sin(np.arange(u0.shape[0]))])
    Ut = torch.tensor(U, requires_grad=True)
    f = tobj(Ut, tm)
    (g,) = torch.autograd.grad(f.sum(), Ut)
    jvg = jax.jit(jax.value_and_grad(jobj))
    for b in range(2):
        val, grad = jvg(jnp.asarray(U[b]), jm)
        assert abs(float(f[b]) - float(val)) <= 1e-10 * abs(float(val))
        np.testing.assert_allclose(g[b].numpy(), np.asarray(grad), rtol=1e-8,
                                   atol=1e-8 * np.abs(np.asarray(grad)).max())


@pytest.mark.parametrize("inference", ["vardtc", "fitc"])
def test_prediction_matches_jax(inference):
    jm, tm = _pair(inference, normalizer=True)
    Xs = np.random.default_rng(1).uniform(-2.5, 2.5, (9, 2))
    jpost, tpost = jax.jit(lambda m: m.inference_state())(jm), tm.inference_state()
    assert bool(tpost.ok)
    jpredict = jax.jit(lambda m, X, p, full: m.predict(X, full_cov=full, posterior=p),
                       static_argnums=3)
    for full_cov in (False, True):
        for got, want in zip(tm.predict(torch.tensor(Xs), full_cov=full_cov, posterior=tpost),
                             jpredict(jm, jnp.asarray(Xs), jpost, full_cov)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)
    for got, want in zip(tm.predict_quantiles(torch.tensor(Xs), posterior=tpost),
                         jm.predict_quantiles(jnp.asarray(Xs), posterior=jpost)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    # the predictive gradients against central differences of the predictions
    dmu, dvar = tm.predictive_gradients(torch.tensor(Xs), posterior=tpost)
    h = 1e-6
    for k in range(2):
        e = np.zeros(2)
        e[k] = h
        up = tm.predict(torch.tensor(Xs + e), include_likelihood=False, posterior=tpost)
        dn = tm.predict(torch.tensor(Xs - e), include_likelihood=False, posterior=tpost)
        np.testing.assert_allclose(dmu[:, k].numpy(), ((up[0] - dn[0]) / (2 * h)).numpy(),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(dvar[:, k].numpy(), ((up[1] - dn[1]) / (2 * h))[:, 0].numpy(),
                                   rtol=1e-5, atol=1e-8)
    mu = tm.predict_mean(torch.tensor(Xs), tpost)
    np.testing.assert_allclose(mu.numpy(), tm.predict(torch.tensor(Xs), posterior=tpost)[0],
                               rtol=1e-12)


def test_missing_data_bound_matches_jax():
    jm, tm = _pair("vardtc", p=2)
    mask = (np.random.default_rng(2).uniform(size=(26, 2)) > 0.3).astype(float)
    mask = np.vstack([mask, np.ones((6, 2))])
    np.testing.assert_allclose(float(tm.missing_data_lml(mask)),
                               float(jm.missing_data_lml(jnp.asarray(mask))), rtol=1e-10)


def test_kmm_init_matches_jax():
    X, _ = _data()
    np.testing.assert_array_equal(kmm_init(X, 6, np.random.default_rng(3)),
                                  jsparse.kmm_init(X, 6, np.random.default_rng(3)))


def test_with_data_and_convert():
    """``with_data`` keeps Z, the noise, the inference and PEP's alpha;
    ``convert.sparse_from_leaves`` rebuilds the JAX model's bound."""
    jm, tm = _pair("pep")
    tm = SparseGPRegression(**{**tm.__dict__, "pep_alpha": 0.3})
    X, Y = _data(n=30, seed=5)
    again = tm.with_data(X, Y, max_points=32)
    assert again.pep_alpha == 0.3 and again.inference == "pep"
    assert torch.equal(again.Z, tm.Z) and int(again.num_data) == 30
    leaves = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
              "likelihood_variance": jm.likelihood_variance, "Z": jm.Z, "X": jm.X, "Y": jm.Y,
              "mask": jm.mask}
    back = convert.sparse_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                      family="rbf", inference="pep", device="cpu")
    np.testing.assert_allclose(float(back.log_marginal_likelihood()),
                               float(jm.log_marginal_likelihood()), rtol=1e-10)


def test_sparse_bo_model_matches_jax():
    """(test_models_extra.py::test_sparse_bo_model) one restart of 15 L-BFGS
    steps on the same data: the fitted parameters, Z, the predictions and their
    gradients, and fmin."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(30, 1))
    Y = np.sin(2 * X) + 0.05 * rng.standard_normal((30, 1))
    theirs = JSparseModel(num_inducing=6, optimize_restarts=1, max_iters=15)
    ours = SparseGPModel(num_inducing=6, optimize_restarts=1, max_iters=15, device="cpu")
    theirs.updateModel(X, Y)
    ours.updateModel(X, Y)
    np.testing.assert_allclose(ours.get_model_parameters(), theirs.get_model_parameters(),
                               rtol=1e-6)
    np.testing.assert_allclose(ours.model.Z.numpy(), np.asarray(theirs.model.Z), rtol=1e-6,
                               atol=1e-8)
    for got, want in zip(ours.predict(X[:5]), theirs.predict(X[:5])):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    for got, want in zip(ours.predict_withGradients(X[:3]), theirs.predict_withGradients(X[:3])):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert ours.get_fmin() == pytest.approx(theirs.get_fmin(), rel=1e-6)
    assert ours.get_model_parameters_names() == list(theirs.get_model_parameters_names())


@pytest.mark.parametrize("inference", ["vardtc", "fitc", "dtc", "pep"])
def test_f32_bound_error_is_the_references(inference):
    """At the large-scale sparse configuration (X uniform in [-3, 3]^2, RBF,
    noise 0.05, 256 inducing inputs, N = 50 000) Kmm's condition number is
    above float32's 1 / eps, so neither package's float32 bound meets its
    float64 bound to 1e-4. The port's float32 error, against the port's
    float64 on the same leaves, is within 2x of the JAX package's against
    its own."""
    from gaussian_process_optimization_tpu_torch import workload

    X, Y = workload.sparse_data()
    t32 = workload.sparse_model(X, Y, inference=inference, device="cpu", dtype=torch.float32)
    X, Y, Z = (t.double().numpy() for t in (t32.X, t32.Y, t32.Z))
    j64 = jsparse.SparseGPRegression.create(
        X, Y, kernel=jk.RBF.create(2, variance=1.0, lengthscale=1.0), Z=Z,
        noise_var=float(t32.likelihood_variance),
        inference=inference)
    j32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if getattr(a, "dtype", None) == jnp.float64 else a,
        j64)
    jb64, jb32 = float(j64.log_marginal_likelihood()), float(j32.log_marginal_likelihood())
    with torch.no_grad():
        tb32 = float(t32.log_marginal_likelihood())
        tb64 = float(tree_map(lambda t: t.double(), t32).log_marginal_likelihood())
    assert tb64 == pytest.approx(jb64, rel=1e-10)
    jax_err, port_err = abs(jb32 - jb64) / abs(jb64), abs(tb32 - tb64) / abs(tb64)
    print(f"{inference}: f32 bound rel error JAX {jax_err:.3e}, port {port_err:.3e}")
    assert port_err <= 2.0 * jax_err + 1e-6, (port_err, jax_err)

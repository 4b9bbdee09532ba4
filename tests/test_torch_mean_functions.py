"""The torch port's mean functions and the rest of the exact GP's API against
the JAX package, in float64: the mappings and their parameter gradients; the
-LML and its gradient for models with a mean function or per-point noise (with
lanes, B = N included); full-covariance and noiseless prediction, the noise at
test points, posterior samples on injected normals, quantiles, predictive
densities, ``predict_jacobian`` and the leave-one-out density; and the linear
algebra those call."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import mean_functions as jmf
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.ops import linalg as jlinalg
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch import kernels as tk
from gaussian_process_optimization_tpu_torch.models import fit as tfit
from gaussian_process_optimization_tpu_torch.models import mean_functions as tmf
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.ops import linalg as tlinalg
from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, replace_leaves
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
D = 3


def _t(a, **kw):
    return torch.tensor(np.asarray(a), dtype=torch.float64, **kw)


def _kernels():
    ls = np.array([0.7, 1.4, 0.9])
    return (jk.Matern52(input_dim=D, variance=jnp.asarray(1.3), lengthscale=jnp.asarray(ls)),
            tk.Matern52(input_dim=D, variance=_t(1.3), lengthscale=_t(ls)))


def _mapping_pair(name, rng):
    """The same mapping in both packages, with parameters away from zero."""
    A = rng.standard_normal((D, 1))
    if name == "Constant":
        return jmf.Constant.create(D, value=0.7), tmf.Constant.create(D, value=0.7, device="cpu")
    if name == "LinearMapping":
        return jmf.LinearMapping.create(D, A=A), tmf.LinearMapping.create(D, A=A, device="cpu")
    if name == "Identity":
        return jmf.Identity.create(D), tmf.Identity.create(D)
    if name == "MLPMapping":
        return (jmf.MLPMapping.create(D, 1, hidden_dim=4, seed=5),
                tmf.MLPMapping.create(D, 1, hidden_dim=4, seed=5, device="cpu"))
    if name == "KernelMapping":
        Z = rng.uniform(-2, 2, (4, D))
        jkern, tkern = _kernels()
        return (jmf.KernelMapping.create(D, 1, Z, kernel=jkern, seed=2),
                tmf.KernelMapping.create(D, 1, Z, kernel=tkern, seed=2, device="cpu"))
    if name == "Additive":
        (j1, t1), (j2, t2) = _mapping_pair("Constant", rng), _mapping_pair("LinearMapping", rng)
        return (jmf.Additive(input_dim=D, output_dim=1, m1=j1, m2=j2),
                tmf.Additive(input_dim=D, output_dim=1, m1=t1, m2=t2))
    if name == "Compound":
        B = rng.standard_normal((D, D))
        (j2, t2) = _mapping_pair("MLPMapping", rng)
        return (jmf.Compound(input_dim=D, output_dim=1,
                             m1=jmf.LinearMapping.create(D, D, A=B), m2=j2),
                tmf.Compound(input_dim=D, output_dim=1,
                             m1=tmf.LinearMapping.create(D, D, A=B, device="cpu"), m2=t2))
    raise KeyError(name)


MAPPINGS = ["Constant", "LinearMapping", "Identity", "MLPMapping", "KernelMapping",
            "Additive", "Compound"]


@pytest.mark.parametrize("name", MAPPINGS)
def test_mapping_matches_jax(name, rng):
    """f(X) and the gradient of a weighted sum of it with respect to every
    parameter, 1e-9."""
    j, t = _mapping_pair(name, rng)
    X = rng.uniform(-2, 2, (9, D))
    want = np.asarray(j.f(jnp.asarray(X)))
    W = rng.standard_normal(want.shape)
    np.testing.assert_allclose(t.f(_t(X)).numpy(), want, rtol=RTOL)
    leaves = [v.clone().requires_grad_(True) for _, v in named_leaves(t)]
    if not leaves:
        return
    jg = jax.grad(lambda m: jnp.sum(m.f(jnp.asarray(X)) * W))(j)
    out = torch.sum(replace_leaves(t, leaves).f(_t(X)) * _t(W))
    for g, wantg in zip(torch.autograd.grad(out, leaves), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wantg), rtol=RTOL, atol=1e-12)


def test_piecewise_linear_matches_jax(rng):
    """Inside, at and outside the breaks (given out of order), values and the
    gradients with respect to ``values`` and ``breaks``."""
    values, breaks = [0.5, -0.3, 1.2, 0.1], [0.4, -1.0, 1.5, -0.2]
    j, t = jmf.PiecewiseLinear.create(values, breaks), tmf.PiecewiseLinear.create(
        values, breaks, device="cpu")
    x = np.concatenate([rng.uniform(-2.5, 2.5, 20), [-1.0, 1.5]])[:, None]
    np.testing.assert_allclose(t.f(_t(x)).numpy(), np.asarray(j.f(jnp.asarray(x))), rtol=RTOL)
    x = x[:20]
    W = rng.standard_normal((20, 1))
    jg = jax.grad(lambda m: jnp.sum(m.f(jnp.asarray(x)) * W))(j)
    v, b = t.values.clone().requires_grad_(True), t.breaks.clone().requires_grad_(True)
    out = torch.sum(tmf.PiecewiseLinear(values=v, breaks=b).f(_t(x)) * _t(W))
    gv, gb = torch.autograd.grad(out, (v, b))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jg.values), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jg.breaks), rtol=RTOL, atol=1e-12)


def _models(rng, mean=None, noise=0.2, n=14, max_points=16, normalizer=False):
    X, Y = rng.uniform(-2, 2, (n, D)), rng.standard_normal((n, 1)) + 0.5
    jkern, tkern = _kernels()
    jm_, tm_ = _mapping_pair(mean, rng) if mean else (None, None)
    jm = JGP.create(X, Y, kernel=jkern, noise_var=noise, mean_function=jm_,
                    max_points=max_points, normalizer=normalizer)
    tm = GPRegression.create(X, Y, kernel=tkern, noise_var=noise, mean_function=tm_,
                             max_points=max_points, normalizer=normalizer, device="cpu")
    return jm, tm


def _compare_objective(jm, tm, rng, lanes=3):
    jp, tp = jmake_packer(jm), make_packer(tm)
    assert tp.num_free == jp.num_free
    np.testing.assert_allclose(tp.pack(tm).numpy(), np.asarray(jp.pack(jm)), rtol=1e-13)
    jobj, tobj = jfit.make_objective(jp), tfit.make_objective(tp)
    U = tp.pack(tm)[None] + _t(rng.normal(0, 0.3, (lanes, tp.num_free)))
    Ur = U.clone().requires_grad_(True)
    f = tobj(Ur, tm)
    assert f.shape == (lanes,)
    (g,) = torch.autograd.grad(f.sum(), Ur)
    for b in range(lanes):
        jf, jg = jax.value_and_grad(lambda u: jobj(u, jm))(jnp.asarray(U[b].numpy()))
        np.testing.assert_allclose(float(f[b].detach()), float(jf), rtol=1e-8)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(jg), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mean", ["Constant", "LinearMapping", "MLPMapping", "Additive"])
def test_mean_function_lml_and_gradient_match_jax(mean, rng):
    """The packed vector (the mapping's leaves follow the noise) and
    -LML with its gradient, 1e-8, three lanes at once: the mapping's gradient
    reaches it through the centred targets."""
    jm, tm = _models(rng, mean=mean)
    _compare_objective(jm, tm, rng)


def test_checkgrad_on_a_linear_mean(rng):
    _, tm = _models(rng, mean="LinearMapping")
    assert tfit.checkgrad(tm)
    free = [p for (p, _), fx in zip(named_leaves(tm), make_packer(tm).fixed) if not fx]
    assert free == ["kern.variance", "kern.lengthscale", "likelihood_variance",
                    "mean_function.A"]


@pytest.mark.parametrize("n,max_points,lanes", [(14, 16, 3), (5, None, 5), (5, 8, 5),
                                                (6, None, 5), (4, None, 5)],
                         ids=["padded", "B=N=5", "B=5,N=5,padded", "N=B+1", "N=B-1"])
def test_heteroscedastic_lml_and_gradient_match_jax(n, max_points, lanes, rng):
    """One noise per row, as many lanes as rows and its neighbours: the static
    flag, not the shape, says which axis is which."""
    noise = rng.uniform(0.1, 0.4, n)
    jm, tm = _models(rng, noise=noise, n=n, max_points=max_points)
    assert tm.heteroscedastic and tm.likelihood_variance.shape == (max_points or n,)
    _compare_objective(jm, tm, rng, lanes=lanes)


def test_homoscedastic_lanes_equal_to_rows(rng):
    """Five lanes of scalar noise on five rows: still one variance per lane."""
    jm, tm = _models(rng, n=5, max_points=None)
    assert not tm.heteroscedastic
    _compare_objective(jm, tm, rng, lanes=5)


def test_heteroscedastic_with_data_and_convert(rng):
    noise = rng.uniform(0.1, 0.4, 14)
    jm, tm = _models(rng, noise=noise)
    X2, Y2 = rng.uniform(-2, 2, (14, D)), rng.standard_normal((14, 1))
    again = tm.with_data(X2, Y2, max_points=16)
    np.testing.assert_array_equal(again.likelihood_variance.numpy()[:14], noise)
    with pytest.raises(ValueError, match="heteroscedastic"):
        tm.with_data(X2[:9], Y2[:9], max_points=16)
    leaves = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
              "likelihood_variance": jm.likelihood_variance, "X": jm.X, "Y": jm.Y,
              "mask": jm.mask}
    got = convert.gp_from_leaves({k: np.asarray(v) for k, v in leaves.items()}, device="cpu")
    assert got.heteroscedastic
    np.testing.assert_allclose(float(got.log_marginal_likelihood()),
                               float(jm.log_marginal_likelihood()), rtol=1e-10)


def test_mean_function_model_converts(rng):
    jm, tm = _models(rng, mean="LinearMapping")
    leaves = {"kern.variance": jm.kern.variance, "kern.lengthscale": jm.kern.lengthscale,
              "likelihood_variance": jm.likelihood_variance, "X": jm.X, "Y": jm.Y,
              "mask": jm.mask, "mean_function.A": jm.mean_function.A}
    got = convert.gp_from_leaves({k: np.asarray(v) for k, v in leaves.items()},
                                 mean_function="LinearMapping", device="cpu")
    assert list(convert.leaves_of(got)) == list(convert.leaves_of(tm))
    np.testing.assert_allclose(float(got.log_marginal_likelihood()),
                               float(jm.log_marginal_likelihood()), rtol=1e-10)


@pytest.fixture(params=["plain", "mean+normalizer"])
def predictive(request, rng):
    mean = "LinearMapping" if request.param != "plain" else None
    jm, tm = _models(rng, mean=mean, normalizer=request.param != "plain")
    Xs = rng.uniform(-2, 2, (6, D))
    return jm, tm, Xs, jm.inference(), tm.inference(precompute_inverse=True)


def test_predict_full_cov_and_noiseless_match_jax(predictive):
    jm, tm, Xs, jpost, tpost = predictive
    for kw in (dict(full_cov=True), dict(full_cov=False),
               dict(full_cov=True, include_likelihood=False)):
        mu, var = tm.predict(_t(Xs), posterior=tpost, **kw)
        jmu, jvar = jm.predict(jnp.asarray(Xs), posterior=jpost, **kw)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=RTOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=RTOL, atol=1e-13)
    mu, var = tm.predict_noiseless(_t(Xs))
    jmu, jvar = jm.predict_noiseless(jnp.asarray(Xs))
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=RTOL)
    np.testing.assert_allclose(tm.predict_mean(_t(Xs), tpost).numpy(), np.asarray(jmu),
                               rtol=RTOL)


def test_posterior_samples_on_injected_normals_match_jax(predictive):
    """The JAX sampler's own normals (drawn from its key as it draws them)
    handed to the port: the same samples."""
    jm, tm, Xs, _, _ = predictive
    key = jax.random.PRNGKey(3)
    z = jax.random.normal(key, (6, 4), dtype=jnp.float64)
    want = jm.posterior_samples_f(jnp.asarray(Xs), 4, key)
    got = tm.posterior_samples_f(_t(Xs), 4, z=_t(np.asarray(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)
    key_f, key_n = jax.random.split(key)
    z2 = np.stack([np.asarray(jax.random.normal(k, (6, 4), dtype=jnp.float64))
                   for k in (key_f, key_n)])
    want = jm.posterior_samples(jnp.asarray(Xs), 4, key)
    got = tm.posterior_samples(_t(Xs), 4, z=_t(z2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-10)
    drawn = tm.posterior_samples_f(_t(Xs), 3, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (6, 3) and bool(torch.isfinite(drawn).all())


def test_quantiles_densities_and_covariances_match_jax(predictive, rng):
    jm, tm, Xs, jpost, tpost = predictive
    for got, want in zip(tm.predict_quantiles(_t(Xs), (2.5, 50.0, 97.5)),
                         jm.predict_quantiles(jnp.asarray(Xs), (2.5, 50.0, 97.5))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8, atol=1e-12)
    ys = rng.standard_normal((6, 1))
    np.testing.assert_allclose(tm.log_predictive_density(_t(Xs), ys).numpy(),
                               np.asarray(jm.log_predictive_density(jnp.asarray(Xs), ys)),
                               rtol=RTOL)
    X2 = rng.uniform(-2, 2, (4, D))
    np.testing.assert_allclose(
        tm.posterior_covariance_between_points(_t(Xs), _t(X2), tpost).numpy(),
        np.asarray(jm.posterior_covariance_between_points(jnp.asarray(Xs), jnp.asarray(X2),
                                                          jpost)), rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(tm.log_likelihood_LOO().numpy(),
                               np.asarray(jm.log_likelihood_LOO()), rtol=1e-8)


@pytest.mark.parametrize("kernel", ["matern52", "rbf", "add"])
def test_predict_jacobian_matches_jax(kernel, rng):
    """E[df/dx] and Cov[df/dx] at 5 points, 1e-8: the prior curvature from
    ``d2K_dXdX2_diag``, the data term by one forward-mode pass per dimension."""
    X, Y = rng.uniform(-2, 2, (14, D)), rng.standard_normal((14, 1))
    jkern, tkern = _kernels()
    jr = jk.RBF(input_dim=2, active_dims=(0, 2), variance=jnp.asarray(0.6),
                lengthscale=jnp.asarray(0.8))
    tr = tk.RBF(input_dim=2, active_dims=(0, 2), variance=_t(0.6), lengthscale=_t(0.8))
    jkern, tkern = {"matern52": (jkern, tkern), "rbf": (jr, tr),
                    "add": (jkern + jr, tkern + tr)}[kernel]
    jm = JGP.create(X, Y, kernel=jkern, noise_var=0.2, max_points=16)
    tm = GPRegression.create(X, Y, kernel=tkern, noise_var=0.2, max_points=16, device="cpu")
    Xs = rng.uniform(-2, 2, (5, D))
    mean_jac, var_jac = tm.predict_jacobian(_t(Xs))
    jmean, jvar = jm.predict_jacobian(jnp.asarray(Xs))
    assert mean_jac.shape == (5, D, 1) and var_jac.shape == (5, D, D)
    np.testing.assert_allclose(mean_jac.numpy(), np.asarray(jmean), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(var_jac.numpy(), np.asarray(jvar), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mode", ["mean", "scalar", "vector"])
def test_noise_at_test_matches_jax(mode, rng):
    noise = rng.uniform(0.1, 0.4, 14)
    jm, tm = _models(rng, noise=noise)
    Xs = rng.uniform(-2, 2, (6, D))
    with pytest.raises(ValueError, match="ambiguous"):
        tm.predict(_t(Xs))
    arg = {"mean": "mean", "scalar": 0.3, "vector": rng.uniform(0.1, 0.4, 6)}[mode]
    mu, var = tm.predict(_t(Xs), noise_at_test=arg)
    jmu, jvar = jm.predict(jnp.asarray(Xs), noise_at_test=arg)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=RTOL)
    _, cov = tm.predict(_t(Xs), full_cov=True, noise_at_test=arg)
    _, jcov = jm.predict(jnp.asarray(Xs), full_cov=True, noise_at_test=arg)
    np.testing.assert_allclose(cov.numpy(), np.asarray(jcov), rtol=RTOL, atol=1e-13)


def _spd(rng, n=9):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("name", ["cho_solve", "dpotri", "pdinv", "cholupdate", "jitchol"])
def test_linalg_matches_jax(name, rng):
    A, B, x = _spd(rng), rng.standard_normal((9, 3)), rng.standard_normal(9)
    L = np.linalg.cholesky(A)
    if name == "cho_solve":
        got, want = tlinalg.cho_solve(_t(L), _t(B)), jlinalg.cho_solve(jnp.asarray(L),
                                                                         jnp.asarray(B))
    elif name == "dpotri":
        got, want = tlinalg.dpotri(_t(L)), jlinalg.dpotri(jnp.asarray(L))
    elif name == "cholupdate":
        got, want = tlinalg.cholupdate(_t(L), _t(x)), jlinalg.cholupdate(jnp.asarray(L),
                                                                          jnp.asarray(x))
    elif name == "pdinv":
        for g, w in zip(tlinalg.pdinv(_t(A)), jlinalg.pdinv(jnp.asarray(A))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-13)
        return
    else:
        got, jitter, ok = tlinalg.jitchol(_t(A))
        want, _, _ = jlinalg.jitchol(jnp.asarray(A))
        assert bool(ok) and float(jitter) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-13)


def test_cholesky_pullback_matches_jax(rng):
    """d sum(L W) / dA through the ladder's L: the reference's pullback."""
    A, W = _spd(rng), rng.standard_normal((9, 9))
    jg = jax.grad(lambda a: jnp.sum(jlinalg.jitchol(a)[0] * W))(jnp.asarray(A))
    Ar = _t(A, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(tlinalg.jitchol(Ar)[0] * _t(W)), Ar)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=1e-13)


def test_cholupdate_on_a_semidefinite_factor():
    L = torch.zeros(3, 3, dtype=torch.float64)
    x = _t([1.0, 2.0, 3.0])
    out = tlinalg.cholupdate(L, x)
    np.testing.assert_allclose((out @ out.T).numpy(), torch.outer(x, x).numpy(), atol=1e-12)

"""The port's coregionalized models against the JAX package's, in float64 on
the CPU: the ICM / LCM / private kernels; GPCoregionalizedRegression's -LML,
its gradient in the optimizer's coordinates and the per-task prediction; a
3-restart fit with injected starts, lane by lane; the sparse coregionalized
and missing-data models (the latter's restarts injected into both); and a
JAX-fitted ICM carried over by ``convert.multioutput_from_leaves``.
Tolerances: rtol 1e-9 on values, 1e-7 on gradients and fitted iterates."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import multioutput as jmo
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.ops import lbfgs as jlbfgs
from gaussian_process_optimization_tpu_torch import convert
from gaussian_process_optimization_tpu_torch.kernels import Matern52, RBF
from gaussian_process_optimization_tpu_torch.models import multioutput as tmo
from gaussian_process_optimization_tpu_torch.models.fit import Fitter, make_objective
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from test_torch_kernel_zoo import _close, jax_leaves, spec_of
from torch_threads import one_torch_thread  # noqa: F401

CPU = dict(device="cpu")


def _tasks(n=(14, 12, 10), d=2, seed=0):
    rng = np.random.default_rng(seed)
    Xs = [rng.uniform(-2, 2, (k, d)) for k in n]
    base = [np.sin(2 * X[:, 0]) + 0.3 * np.cos(X.sum(1)) for X in Xs]
    Ys = [(1.0 + 0.5 * i) * b + 0.1 * i + 0.05 * rng.standard_normal(len(b))
          for i, b in enumerate(base)]
    return Xs, Ys


def _icm_models(rank=1):
    Xs, Ys = _tasks()
    jm = jmo.GPCoregionalizedRegression(
        Xs, Ys, base_kernel=jk.Matern52.create(2, ARD=True, lengthscale=[0.8, 1.3]), rank=rank,
        noise_var=0.1)
    tm = tmo.GPCoregionalizedRegression(
        Xs, Ys, base_kernel=Matern52.create(2, ARD=True, lengthscale=[0.8, 1.3], **CPU),
        rank=rank, noise_var=0.1, **CPU)
    return jm, tm


def test_icm_lcm_private_kernels_match_jax():
    rng = np.random.default_rng(1)
    X = np.column_stack([rng.standard_normal((9, 2)), rng.integers(0, 3, 9)])
    W, kappa = [[0.5, 0.1], [1.0, -0.2], [-0.3, 0.7]], [0.2, 0.4, 0.1]
    pairs = [
        (jmo.icm_kernel(2, 3, jk.RBF.create(2, lengthscale=0.7), rank=2, W=W, kappa=kappa),
         tmo.icm_kernel(2, 3, RBF.create(2, lengthscale=0.7, **CPU), rank=2, W=W, kappa=kappa)),
        (jmo.lcm_kernel(2, 3, [jk.RBF.create(2), jk.Matern52.create(2, lengthscale=2.0)]),
         tmo.lcm_kernel(2, 3, [RBF.create(2, **CPU), Matern52.create(2, lengthscale=2.0, **CPU)])),
        (jmo.private_kernel(2, 3, jk.RBF.create(2), output=1, kappa=0.7),
         tmo.private_kernel(2, 3, RBF.create(2, **CPU), output=1, kappa=0.7)),
    ]
    for jkern, tkern in pairs:
        _close(tkern.K(torch.tensor(X)), jkern.K(jnp.asarray(X)))
        _close(tkern.Kdiag(torch.tensor(X)), jkern.Kdiag(jnp.asarray(X)))
    Xj, Yj = jmo.build_stacked_XY(*_tasks())
    Xt, Yt = tmo.build_stacked_XY(*_tasks())
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(Yt, Yj)


def _grad(obj, u, model):
    u = u.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(obj(u[None], model)[0], u)
    return g


def test_coregionalized_lml_gradient_and_predict_match_jax():
    jm, tm = _icm_models(rank=2)
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-9)
    jpacker, tpacker = jmake_packer(jm.model), make_packer(tm.model)
    u = tpacker.pack(tm.model).detach()
    np.testing.assert_allclose(u.numpy(), np.asarray(jpacker.pack(jm.model)), rtol=1e-12)
    jobj = jfit.make_objective(jpacker)
    gj = jax.grad(lambda uu: jobj(uu, jm.model))(jnp.asarray(u.numpy()))
    _close(_grad(make_objective(tpacker), u, tm.model), gj, rtol=1e-7)
    Xnew = np.random.default_rng(2).uniform(-2, 2, (6, 2))
    for task in range(3):
        mt, vt = tm.predict(Xnew, task)
        mj, vj = jm.predict(Xnew, task)
        _close(mt, mj, rtol=1e-9)
        _close(vt, vj, rtol=1e-9)


def test_coregionalized_fit_lanes_match_jax():
    """3 injected starts x 10 L-BFGS steps: each lane's f, x and line-search
    trials equal the JAX fit's (the ICM kernel through the lane axis)."""
    jm, tm = _icm_models()
    fitter = Fitter(tm.model, num_restarts=3, maxiter=10, tol=0.0)
    u0 = fitter.packer.pack(tm.model)
    starts = torch.cat([u0[None], fitter.packer.map_restart(
        torch.tensor(np.random.default_rng(7).standard_normal((2, u0.shape[0]))))])
    _, res = fitter.solve(tm.model, starts)
    jpacker = jmake_packer(jm.model)
    jobj = jfit.make_objective(jpacker)

    def solve(u):
        return jlbfgs.minimize(lambda uu: jobj(uu, jm.model), u, maxiter=10, tol=0.0,
                               history=10, max_ls=8, nonmonotone_eta=0.0, grow_backtracked=2.0)

    jres = jax.jit(jax.vmap(solve))(jnp.asarray(starts.numpy()))
    np.testing.assert_array_equal(res.num_ls.numpy(), np.asarray(jres.num_ls))
    np.testing.assert_allclose(res.f.numpy(), np.asarray(jres.f), rtol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-7, atol=1e-9)


def _sparse_models():
    Xs, Ys = _tasks()
    Zs = [X[:4].copy() for X in Xs]
    jm = jmo.SparseGPCoregionalizedRegression(Xs, Ys, Z_list=Zs,
                                              base_kernel=jk.RBF.create(2, lengthscale=0.9))
    tm = tmo.SparseGPCoregionalizedRegression(Xs, Ys, Z_list=Zs,
                                              base_kernel=RBF.create(2, lengthscale=0.9, **CPU),
                                              **CPU)
    return jm, tm


def test_sparse_coregionalized_matches_jax_and_keeps_the_task_column():
    jm, tm = _sparse_models()
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-9)
    jpacker, tpacker = jmake_packer(jm.model), make_packer(tm.model)
    u = tpacker.pack(tm.model).detach()
    jobj = jfit.make_objective(jpacker)
    gj = jax.grad(lambda uu: jobj(uu, jm.model))(jnp.asarray(u.numpy()))
    gt = _grad(make_objective(tpacker), u, tm.model)
    _close(gt, gj, rtol=1e-7)
    Xnew = np.random.default_rng(3).uniform(-2, 2, (5, 2))
    for task in range(3):
        mt, vt = tm.predict(Xnew, task)
        mj, vj = jm.predict(Xnew, task)
        _close(mt, mj, rtol=1e-9)
        _close(vt, vj, rtol=1e-9)
    # the inducing task column: zero gradient, so a fit leaves it on its integers
    task_col = tm.model.Z[:, -1].clone()
    tm.optimize(num_restarts=1, maxiter=5)
    assert torch.equal(tm.model.Z[:, -1], task_col)


def _md_data(n=30, seed=4):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 1))
    idx = rng.integers(0, 3, n)
    Y = np.sin(2 * X[:, 0]) * (1 + 0.3 * idx) + 0.05 * rng.standard_normal(n)
    return X, Y, idx


def test_missing_data_model_matches_jax_with_injected_restarts():
    X, Y, idx = _md_data()
    Z = X[:6].copy()
    jm = jmo.SparseGPRegressionMD(X, Y, idx, kernel=jk.RBF.create(1), Z=Z)
    tm = tmo.SparseGPRegressionMD(X, Y, idx, kernel=RBF.create(1, **CPU), Z=Z, **CPU)
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-9)
    # the JAX method's loop (multioutput.py:188-206) over the same starts
    jpacker = jmake_packer(jm.model)
    mask = jnp.asarray(jm.output_mask)

    def jobj(u):
        return -jpacker.unpack(u).missing_data_lml(mask)

    u0 = jpacker.pack(jm.model)
    starts = np.stack([np.asarray(u0), np.asarray(u0) + 0.3 * np.random.default_rng(5)
                       .standard_normal(u0.shape[0])])
    best_u, best_f = u0, float(jobj(u0))
    for s in starts:
        res = jlbfgs.minimize(jobj, jnp.asarray(s), maxiter=15)
        if np.isfinite(float(res.f)) and float(res.f) < best_f:
            best_u, best_f = res.x, float(res.f)
    info = tm.optimize(maxiter=15, starts=torch.tensor(starts))
    _close(info["objective"], best_f, rtol=1e-8)
    jm.model = jpacker.unpack(best_u)
    Xnew = np.linspace(-2, 2, 5)[:, None]
    for task in range(3):
        mt, vt = tm.predict(Xnew, task)
        mj, vj = jm.predict(Xnew, task)
        _close(mt, mj, rtol=1e-6)
        _close(vt, vj, rtol=1e-6)


def test_missing_data_optimize_draws_its_own_restarts():
    X, Y, idx = _md_data()
    tm = tmo.SparseGPRegressionMD(X, Y, idx, kernel=RBF.create(1, **CPU), Z=X[:6].copy(), **CPU)
    before = -float(tm.log_marginal_likelihood())
    info = tm.optimize(num_restarts=2, maxiter=10, generator=torch.Generator().manual_seed(1))
    assert info["objective"] <= before
    assert np.isclose(-float(tm.log_marginal_likelihood()), info["objective"])


def test_jax_fitted_icm_carried_by_convert():
    jm, _ = _icm_models()
    jm.optimize(num_restarts=2, maxiter=15, key=jax.random.PRNGKey(0))
    leaves = jax_leaves(jm.model, prefix="")
    tm = convert.multioutput_from_leaves(leaves, spec_of(jm.model.kern), num_outputs=3, **CPU)
    assert tm.num_outputs == 3 and tm.input_dim == 2
    _close(float(tm.log_marginal_likelihood()), float(jm.log_marginal_likelihood()), rtol=1e-10)
    Xnew = np.random.default_rng(6).uniform(-2, 2, (4, 2))
    mt, vt = tm.predict(Xnew, 2)
    mj, vj = jm.predict(Xnew, 2)
    _close(mt, mj, rtol=1e-9)
    _close(vt, vj, rtol=1e-9)

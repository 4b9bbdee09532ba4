"""Calls written for the JAX package bind the same in the port: its positional
order, with the port's ``generator`` / ``rng`` in the place of its ``key``
(ROADMAP C22), and the parameters the port took over last (ROADMAP A23):
``BO(normalization_type=...)``, ``evaluator_creator``'s ``model_type``, the
acquisition optimizer's call forms, ``ensemble_sample(init=...)``,
``fit_gplvm``'s generator and ``make_svgp_train_step(optimizer=...)``. Each is
held against the JAX package in float64 at a small size, through positional
calls where the order is what is checked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.bo import acquisitions as jacq
from gaussian_process_optimization_tpu.bo import evaluators as jev
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.bo_loop import BO as JBO
from gaussian_process_optimization_tpu.bo.designs import initial_design
from gaussian_process_optimization_tpu.bo.mcmc_sampler import ensemble_sample as jensemble
from gaussian_process_optimization_tpu.bo.methods import ArgumentsManager as JArgs
from gaussian_process_optimization_tpu.bo.optimizer import AcquisitionOptimizer as JOptimizer
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import gplvm as jg
from gaussian_process_optimization_tpu.models import hmc as jhmc
from gaussian_process_optimization_tpu.models import laplace as jlap
from gaussian_process_optimization_tpu.models import likelihoods as jl
from gaussian_process_optimization_tpu.models import mean_functions as jmf
from gaussian_process_optimization_tpu.models import svgp as jsvgp
from gaussian_process_optimization_tpu.models.bo_models import GPModel as JGPModel
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.rf_model import RFModel as JRF
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.bo import acquisitions as tacq
from gaussian_process_optimization_tpu_torch.bo import evaluators as tev
from gaussian_process_optimization_tpu_torch.bo.bo_loop import BO
from gaussian_process_optimization_tpu_torch.bo.mcmc_sampler import (ensemble_draws,
                                                                     ensemble_sample)
from gaussian_process_optimization_tpu_torch.bo.methods import ArgumentsManager
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF, Matern52
from gaussian_process_optimization_tpu_torch.models import fit as tfit
from gaussian_process_optimization_tpu_torch.models import gplvm as tg
from gaussian_process_optimization_tpu_torch.models import hmc
from gaussian_process_optimization_tpu_torch.models import laplace as tlap
from gaussian_process_optimization_tpu_torch.models import likelihoods as tl
from gaussian_process_optimization_tpu_torch.models import mean_functions as tmf
from gaussian_process_optimization_tpu_torch.models import multioutput as tmo
from gaussian_process_optimization_tpu_torch.models import svgp as tsvgp
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.rf_model import RFModel
from gaussian_process_optimization_tpu_torch.parallel import sharded as ts
from gaussian_process_optimization_tpu_torch.utils import native as tnative
from test_torch_entropy_search import _log_p, jax_ensemble_draws
from test_torch_hmc import jax_mh_draws
from torch_threads import one_torch_thread  # noqa: F401

DOMAIN = bounds_to_space(objectives.branin.bounds)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def numpy_branch(monkeypatch):
    """Hold both packages' designs to their numpy branch (the native engines
    are held to each other in tests/test_torch_native.py)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _branin_data(n=10, seed=1):
    X = initial_design("latin", JSpace(DOMAIN), n, seed=seed)
    return X, np.asarray(objectives.branin(X))


@pytest.fixture(scope="module")
def models():
    """Both packages' GP surrogates on 12 latin points of branin, not fitted
    (``max_iters=0``): the same posterior."""
    X, Y = _branin_data(12)
    Y = (Y - Y.mean()) / Y.std()
    jgm, tgm = JGPModel(exact_feval=True, max_iters=0), GPModel(exact_feval=True, max_iters=0,
                                                                **CPU)
    jgm.updateModel(X, Y)
    tgm.updateModel(X, Y)
    return jgm, tgm


# ------------------------------------------------------------- BO.normalization_type
def _loop(pkg, X, Y, normalization_type):
    if pkg == "jax":
        space = JSpace(DOMAIN)
        model = JGPModel(exact_feval=True, max_iters=0)
        opt = JOptimizer(space, "lbfgs", model=model, num_samples=200, num_anchor=3)
        acq = jacq.AcquisitionEI(model, space, opt)
        return JBO(model, space, None, acq, jev.Sequential(acq), X, Y,
                   normalization_type=normalization_type)
    space = DesignSpace(DOMAIN)
    model = GPModel(exact_feval=True, max_iters=0, **CPU)
    opt = AcquisitionOptimizer(space, "lbfgs", model=model, num_samples=200, num_anchor=3)
    acq = tacq.AcquisitionEI(model, space, opt)
    return BO(model, space, None, acq, tev.Sequential(acq), X, Y,
              normalization_type=normalization_type)


@pytest.mark.parametrize("normalization_type", ["stats", "maxmin"])
def test_bo_normalization_type_matches_jax(normalization_type):
    """One ``suggest_next_locations`` of a BO built with ``normalization_type``:
    the JAX package's point, 1e-6; the value is stored and, as in the
    reference, Y is normalized by its stats whatever it says."""
    X, Y = _branin_data()
    theirs, ours = (_loop(p, X, Y, normalization_type) for p in ("jax", "torch"))
    assert ours.normalization_type == theirs.normalization_type == normalization_type
    x = ours.suggest_next_locations()
    np.testing.assert_allclose(x, theirs.suggest_next_locations(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(x, _loop("torch", X, Y, "stats").suggest_next_locations())


# ------------------------------------------------------------- evaluator_creator
@pytest.mark.parametrize("evaluator_type",
                         ["sequential", "random", "thompson_sampling", "local_penalization"])
def test_evaluator_creator_positional_matches_jax(evaluator_type, models):
    """The reference's positional form, ``model_type`` at 4 and unused: the
    same evaluator class, batch size and acquisition class."""
    jgm, tgm = models
    out = []
    for args, gm, space, opt_cls, acq_mod in (
            (JArgs({}), jgm, JSpace(DOMAIN), JOptimizer, jacq),
            (ArgumentsManager({}), tgm, DesignSpace(DOMAIN), AcquisitionOptimizer, tacq)):
        opt = opt_cls(space, "lbfgs", model=gm)
        acq = acq_mod.AcquisitionEI(gm, space, opt)
        out.append(args.evaluator_creator(evaluator_type, acq, 3, "GP", gm, space, opt))
    theirs, ours = out
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.batch_size == theirs.batch_size
    assert type(ours.acquisition).__name__ == type(theirs.acquisition).__name__


# ------------------------------------------------------------- optimizer call forms
def _pair(models, surrogate, seed=0):
    """(reference acquisition, the port's), each with its own optimizer built
    with ``seed``: EI over the GP surrogates, or over a 20-tree forest."""
    jgm, tgm = models
    if surrogate == "RF":
        X, Y = _branin_data(16, seed=2)
        jgm, tgm = JRF(n_estimators=20, seed=3), RFModel(n_estimators=20, seed=3)
        jgm.updateModel(X, Y)
        tgm.updateModel(X, Y)
    kw = dict(num_samples=200, num_anchor=3, maxiter=40, seed=seed)
    jspace, tspace = JSpace(DOMAIN), DesignSpace(DOMAIN)
    return (jacq.AcquisitionEI(jgm, jspace, JOptimizer(jspace, "lbfgs", model=jgm, **kw)),
            tacq.AcquisitionEI(tgm, tspace, AcquisitionOptimizer(tspace, "lbfgs", model=tgm,
                                                                 **kw)))


FORMS = {
    "acq.optimize()": lambda a: a.optimize(),
    "f, f_df, acquisition": lambda a: a.optimizer.optimize(
        f=a.acquisition_function, f_df=a.acquisition_function_withGradients, acquisition=a),
    "f": lambda a: a.optimizer.optimize(f=a.acquisition_function),
    "optimize_host(f, df)": lambda a: a.optimizer.optimize_host(f=a.acquisition_function,
                                                                df=lambda x: None),
}


@pytest.mark.parametrize("form,surrogate", [(f, "GP") for f in FORMS] + [
    (f, "RF") for f in FORMS if "f_df" not in f])
def test_optimizer_call_forms_match_jax(form, surrogate, models):
    """Each call form gives the JAX package's point, 1e-6: the device path
    where the acquisition is given and has tensor state, else scipy on ``f``
    alone (the forest's ``acq.optimize()`` too: it has no gradients), ``df``
    ignored."""
    ja, ta = _pair(models, surrogate)
    jx, jf = FORMS[form](ja)
    tx, tf = FORMS[form](ta)
    assert tx.shape == (1, 2) and tf.shape == (1, 1)
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=1e-6, atol=1e-9)


def test_optimize_with_f_df_and_acquisition_is_acq_optimize(models):
    """Two optimizers built with the same seed: ``optimize(f=, f_df=,
    acquisition=)`` gives ``acq.optimize()``'s point bit for bit."""
    _, a = _pair(models, "GP")
    _, b = _pair(models, "GP")
    x, f = a.optimize()
    y, g = b.optimizer.optimize(f=b.acquisition_function,
                                f_df=b.acquisition_function_withGradients, acquisition=b)
    np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(f, g)


def test_optimizer_takes_and_ignores_other_keywords():
    opt = AcquisitionOptimizer(DesignSpace(DOMAIN), "lbfgs", num_samples=50, type_anchor="x")
    assert opt.num_samples == 50 and not hasattr(opt, "type_anchor")


# ------------------------------------------------------------- ensemble_sample(init=)
def test_ensemble_sample_init_matches_jax():
    """``init`` through the reference's positional call, the moves on the JAX
    key's draws: the JAX chain, 1e-12; the chain from the same draws whose
    initial walkers are ``init``, bit for bit."""
    lower, upper = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    init = np.random.default_rng(2).uniform(-0.5, 0.5, (8, 2))
    key = jax.random.PRNGKey(5)
    jchain, jw = jensemble(_log_p(jnp), jnp.asarray(lower), jnp.asarray(upper), 8, 12, key,
                           2.0, jnp.asarray(init))
    draws = jax_ensemble_draws(key, lower, upper, 8, 12)
    tl_, tu_ = torch.tensor(lower), torch.tensor(upper)
    tchain, tw = ensemble_sample(_log_p(torch), tl_, tu_, 8, 12, None, 2.0, torch.tensor(init),
                                 draws=draws)
    np.testing.assert_allclose(tchain.numpy(), np.asarray(jchain), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12, atol=1e-14)
    same, _ = ensemble_sample(_log_p(torch), tl_, tu_, 8, 12,
                              draws=dataclasses.replace(draws, init=torch.tensor(init)))
    assert torch.equal(same, tchain)
    # from a generator: its draws, the walkers starting at init
    gen, gen2 = (torch.Generator().manual_seed(4) for _ in range(2))
    ours, _ = ensemble_sample(_log_p(torch), tl_, tu_, 8, 12, gen, init=torch.tensor(init))
    want, _ = ensemble_sample(_log_p(torch), tl_, tu_, 8, 12, draws=dataclasses.replace(
        ensemble_draws(tl_, tu_, 8, 12, gen2), init=torch.tensor(init)))
    assert torch.equal(ours, want)


# ------------------------------------------------------------- fit_gplvm(generator)
def test_fit_gplvm_generator_is_unused():
    """``fit_gplvm(m, 30, generator)``, the reference's positional form: the
    fit without the generator, bit for bit, and the JAX package's, 1e-6."""
    Y = np.random.default_rng(0).standard_normal((20, 4))
    jm = jg.make_gplvm(Y, 2, kernel=jk.RBF.create(2, ARD=True))
    tm = tg.make_gplvm(Y, 2, kernel=RBF.create(2, ARD=True, **CPU), **CPU)
    ours, res = tg.fit_gplvm(tm, 30, torch.Generator().manual_seed(3))
    plain, res0 = tg.fit_gplvm(tm, maxiter=30)
    assert torch.equal(res.x, res0.x) and torch.equal(ours.X, plain.X)
    theirs, jres = jg.fit_gplvm(jm, 30, jax.random.PRNGKey(3))
    np.testing.assert_allclose(float(res.f), float(jres.f), rtol=1e-6)


# ------------------------------------------------------------- make_svgp_train_step
def _svgp_pair():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2.0, 2.0, (60, 2))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((60, 1))
    jm = jsvgp.SVGP.create(X, Y, num_inducing=8, seed=0)
    tm = tsvgp.SVGP.create(X, Y, num_inducing=8, seed=0, dtype=torch.float64, **CPU)
    return X, Y, jm, tm, [rng.permutation(60)[:16] for _ in range(3)]


def test_svgp_sgd_train_step_matches_optax():
    """``make_svgp_train_step(SGD factory)`` against ``optax.sgd`` at the same
    rate: u after 3 steps, 1e-10, and each step's -ELBO."""
    X, Y, jm, tm, batches = _svgp_pair()
    lr = 0.05
    _, ju, jstate, jstep = jsvgp.make_svgp_train_step(optax.sgd(lr))(jm)
    _, tu, topt, tstep = tsvgp.make_svgp_train_step(lambda p: torch.optim.SGD(p, lr=lr))(tm)
    assert isinstance(topt, torch.optim.SGD)
    for idx in batches:
        ju, jstate, jloss = jstep(ju, jstate, jm, jnp.asarray(X[idx]), jnp.asarray(Y[idx]))
        tloss = tstep(torch.tensor(X[idx]), torch.tensor(Y[idx]))
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-10)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), rtol=1e-10, atol=1e-12)


def test_svgp_default_train_step_is_adam_at_optax_settings():
    """The default factory: Adam at ``learning_rate`` with optax's betas and
    eps, bit for bit over 3 steps."""
    X, Y, _, tm, batches = _svgp_pair()
    runs = []
    for optimizer in (None, lambda p: torch.optim.Adam(p, lr=0.02, betas=(0.9, 0.999),
                                                       eps=1e-8)):
        _, u, _, step = tsvgp.make_svgp_train_step(optimizer, 0.02)(tm)
        for idx in batches:
            step(torch.tensor(X[idx]), torch.tensor(Y[idx]))
        runs.append(u.detach())
    assert torch.equal(*runs)


def test_svgp_num_data_default_matches_jax():
    assert tsvgp.SVGP().num_data == jsvgp.SVGP().num_data == 0


# ------------------------------------------------------------- Fitter, fit, GPModel
def test_fitter_positional_matches_jax():
    """``Fitter(m, 3, 20, ("likelihood_variance",))``: the tuple is ``fix`` in
    both packages (the noise stays where it was), and from the JAX key's starts
    each lane's f and x are the JAX fit's."""
    X, Y = workload.bench_data(n=32, seed=1)
    jm = JGP.create(X, Y, kernel=jk.Matern52.create(6, ARD=True), noise_var=0.05,
                    max_points=32)
    tm = workload.make_model(X, Y, dtype=torch.float64, **CPU)
    fix = ("likelihood_variance",)
    ours = tfit.Fitter(tm, 3, 20, fix)
    theirs = jfit.Fitter(jm, 3, 20, fix)
    assert ours.tol == 1e-5 and ours.packer.fixed == theirs.packer.fixed
    key = jax.random.PRNGKey(1)
    jfitted, jres = theirs(jm, key)
    u0 = ours.packer.pack(tm)
    z = np.asarray(jax.random.normal(key, (2, u0.shape[0]), dtype=jnp.float64))
    starts = torch.cat([u0[None], ours.packer.map_restart(torch.tensor(z))])
    fitted, res = ours.solve(tm, starts)
    np.testing.assert_array_equal(res.num_iters.numpy(), np.asarray(jres.num_iters))
    np.testing.assert_allclose(res.f.numpy(), np.asarray(jres.f), rtol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x), rtol=1e-7, atol=1e-9)
    assert float(fitted.likelihood_variance) == float(tm.likelihood_variance)
    assert float(jfitted.likelihood_variance) == float(jm.likelihood_variance)


def test_fit_and_multioutput_optimize_take_jit():
    """``fit(..., jit)`` at the reference's position 7, and ``jit=`` through the
    multi-output models' ``optimize``: taken and ignored."""
    X, Y = workload.bench_data(n=24, seed=2)
    tm = workload.make_model(X, Y, dtype=torch.float64, **CPU)
    a, ra = tfit.fit(tm, 2, 5, torch.Generator().manual_seed(0), (), None, None, False)
    b, rb = tfit.fit(tm, 2, 5, torch.Generator().manual_seed(0))
    assert torch.equal(ra.x, rb.x)
    rng = np.random.default_rng(0)
    Xs = [rng.uniform(-2, 2, (k, 2)) for k in (10, 8)]
    Ys = [np.sin(x[:, 0]) for x in Xs]
    for cls, kern in ((tmo.GPCoregionalizedRegression, Matern52.create),
                      (tmo.SparseGPCoregionalizedRegression, RBF.create)):
        one, two = (cls(Xs, Ys, base_kernel=kern(2, **CPU), **CPU) for _ in range(2))
        one.optimize(1, 3, torch.Generator().manual_seed(0), jit=False)
        two.optimize(1, 3, torch.Generator().manual_seed(0))
        assert float(one.log_marginal_likelihood()) == float(two.log_marginal_likelihood())


def test_gpmodel_positional_seed_and_mean_function_match_jax():
    """``GPModel(..., mean_function, 7)``: the mean function at 10 and the seed
    at 11 in both packages; the unfitted surrogate predicts as the JAX one."""
    X, Y = _branin_data(10)
    jgm = JGPModel(None, None, True, "lbfgs", 0, 5, False, False, False, None,
                   jmf.Constant.create(2, value=1.5), 7)
    tgm = GPModel(None, None, True, "lbfgs", 0, 5, False, False, False, None,
                  tmf.Constant.create(2, value=1.5, **CPU), 7, **CPU)
    assert tgm.generator.initial_seed() == 7
    np.testing.assert_array_equal(np.asarray(jgm._key), np.asarray(jax.random.PRNGKey(7)))
    jgm.updateModel(X, Y)
    tgm.updateModel(X, Y)
    Xs = _branin_data(5, seed=4)[0]
    for a, b in zip(tgm.predict(Xs), jgm.predict(Xs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)


def test_sharded_fit_positional_max_ls():
    """``make_sharded_multistart_fit(m, mesh, 1, 40, 0.0, 3)``: 3 is ``max_ls``,
    at the reference's position 5, and ``fix`` keeps its default."""
    X, Y = workload.bench_data(n=16, seed=0)
    tm = workload.make_model(X, Y, dtype=torch.float64, **CPU)
    fitter = ts.make_sharded_multistart_fit(tm, ts.make_mesh(2, **CPU), 1, 40, 0.0, 3)
    assert (fitter.max_ls, fitter.maxiter, fitter.tol, fitter.num_restarts) == (3, 40, 0.0, 2)
    assert fitter.packer.fixed == tfit.Fitter(tm).packer.fixed


# ------------------------------------------------------------- key in the reference's place
def test_metropolis_hastings_positional_matches_jax():
    """``metropolis_hastings(logpost, u0, key, 300, 100, 5)``: the generator in
    the key's place, the kept samples the JAX package's, 1e-8."""
    mu, prec = np.array([1.0, -2.0]), np.array([[2.0, 0.3], [0.3, 1.0]])

    def logpost(lib, m, p):
        return lambda u: -0.5 * (u - m) @ p @ (u - m)

    key = jax.random.PRNGKey(3)
    js, *_ = jhmc.metropolis_hastings(logpost(jnp, jnp.asarray(mu), jnp.asarray(prec)),
                                      np.zeros(2), key, 300, 100, 5)
    ts_, *_ = hmc.metropolis_hastings(logpost(torch, torch.tensor(mu), torch.tensor(prec)),
                                      torch.zeros(2, dtype=torch.float64), None, 300, 100, 5,
                                      draws=jax_mh_draws(key, 300, 2, 400))
    assert ts_.shape == (40, 2)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js), rtol=1e-8, atol=1e-10)


def test_gp_sampling_positional():
    """``posterior_samples(X, size, generator, noise_at_test)`` and
    ``log_predictive_density_sampling(x, y, generator, num_samples)``: the
    draws come from the generator at the key's place, and the count at 3 is
    the number of samples."""
    X, Y = workload.bench_data(n=20, seed=3)
    m = workload.make_model(X, Y, dtype=torch.float64, **CPU)
    Xs = torch.tensor(X[:4])
    z = torch.randn((2, 4, 6), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    got = m.posterior_samples(Xs, 6, torch.Generator().manual_seed(1), 0.2)
    assert torch.equal(got, m.posterior_samples(Xs, 6, noise_at_test=0.2, z=z))
    z = torch.randn((4, 7), generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    y = torch.tensor(Y[:4])
    got = m.log_predictive_density_sampling(Xs, y, torch.Generator().manual_seed(2), 7)
    assert torch.equal(got, m.log_predictive_density_sampling(Xs, y, z=z))


@pytest.mark.parametrize("cls", ["GPLaplace", "GPClassification"])
def test_laplace_quantiles_positional_posterior_match_jax(cls):
    """``predict_quantiles(X, q, key, posterior)``: the posterior at the
    reference's position 4 in both packages, the quantiles on the JAX
    package's own draws, 1e-9."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 6, (24, 1)), axis=0)
    Y = (np.sin(X[:, 0]) + 0.3 * rng.standard_normal(24) > 0).astype(float)
    kern = dict(variance=1.3, lengthscale=0.9)
    jm = getattr(jlap, cls).create(X, Y, kernel=jk.RBF.create(1, **kern),
                                   **({"likelihood": jl.Bernoulli()} if cls == "GPLaplace"
                                      else {}))
    tm = getattr(tlap, cls).create(X, Y, kernel=RBF.create(1, **kern, **CPU),
                                   **({"likelihood": tl.Bernoulli()} if cls == "GPLaplace"
                                      else {}), **CPU)
    jpost, tpost = jm.inference(), tm.inference()
    Xs = np.linspace(-0.5, 6.5, 9)[:, None]
    key = jax.random.PRNGKey(5)
    want = jm.predict_quantiles(jnp.asarray(Xs), (10.0, 90.0), key, jpost)
    jmu, jvar = jm._raw_predict(jnp.asarray(Xs))
    kf, ky = jax.random.split(key)
    f = jmu[:, None] + jnp.sqrt(jvar)[:, None] * jax.random.normal(kf, (9, 300),
                                                                   dtype=jnp.float64)
    draws = np.asarray(jm.likelihood.samples(f, ky))
    got = tm.predict_quantiles(Xs, (10.0, 90.0), None, tpost, draws=draws)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-9, atol=1e-11)

"""The torch port's hyperparameter samplers (``models/hmc.py``) against the JAX
package, in float64: the HMC, Metropolis-Hastings and shortcut-HMC chains step
by step under the reference's own draws (reproduced from its ``jax.random`` keys
and injected), on Gaussian targets and on a GP's -(LML + log prior); and the
samplers' moments on a known Gaussian, as the reference's own tests check them
(``tests/test_models_extra.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.models import fit as jfit
from gaussian_process_optimization_tpu.models import hmc as jhmc
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.parameters import make_packer as jmake_packer
from gaussian_process_optimization_tpu.utils.priors import GammaPrior as JGamma
from gaussian_process_optimization_tpu_torch.kernels.stationary import RBF
from gaussian_process_optimization_tpu_torch.models import hmc
from gaussian_process_optimization_tpu_torch.models.fit import make_objective
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.parameters import make_packer
from gaussian_process_optimization_tpu_torch.utils.priors import GammaPrior
from torch_threads import one_torch_thread  # noqa: F401

MU = np.array([1.0, -2.0])
PREC = np.array([[2.0, 0.3], [0.3, 1.0]])


def jax_hmc_draws(key, num_samples, dim):
    """hmc_sample's draws (models/hmc.py:37-44): per step, the momentum and the
    log of the accept uniform."""
    momenta, log_u = [], []
    for k in jax.random.split(key, num_samples):
        k1, k2 = jax.random.split(k)
        momenta.append(np.asarray(jax.random.normal(k1, (dim,), dtype=jnp.float64)))
        log_u.append(np.log(float(jax.random.uniform(k2, dtype=jnp.float64))))
    return torch.tensor(np.stack(momenta)), torch.tensor(np.asarray(log_u))


def _gaussian_potential(lib):
    mu, prec = lib.asarray(MU) if lib is jnp else torch.tensor(MU), \
        lib.asarray(PREC) if lib is jnp else torch.tensor(PREC)

    def potential(u):
        d = u - mu
        return 0.5 * d @ prec @ d
    return potential


@pytest.mark.parametrize("stepsize,steps", [(0.3, 10), (1.2, 5)])
def test_hmc_chain_matches_jax_gaussian(stepsize, steps):
    """20 samples; the large step makes some proposals rejected, so both the
    accept and the reject branch are compared."""
    key = jax.random.PRNGKey(4)
    js, jrate = jhmc.hmc_sample(_gaussian_potential(jnp), jnp.zeros(2), key, num_samples=20,
                                stepsize=stepsize, leapfrog_steps=steps)
    ts, trate = hmc.hmc_sample(_gaussian_potential(torch), torch.zeros(2, dtype=torch.float64),
                               20, stepsize=stepsize, leapfrog_steps=steps,
                               draws=jax_hmc_draws(key, 20, 2))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-12, atol=1e-12)
    assert float(trate) == pytest.approx(float(jrate))
    if stepsize > 1.0:
        assert 0.0 < float(trate) < 1.0


def _gp_pair(rng, n=24, d=2):
    X = rng.uniform(-2.0, 2.0, (n, d))
    Y = np.sin(2.0 * X[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    jm = JGP.create(X, Y, kernel=jk.RBF.create(d), noise_var=0.05, max_points=32)
    tm = GPRegression.create(X, Y, kernel=RBF.create(d, device="cpu"), noise_var=0.05,
                             max_points=32, device="cpu")
    return jm, tm


def test_hmc_chain_matches_jax_on_gp_posterior(rng):
    """HMC on -(LML + Gamma(2, 4) log priors), GPModel_MCMC's potential: 5
    samples of 3 leapfrog steps, step by step within 1e-8."""
    jm, tm = _gp_pair(rng)
    jg, tg = JGamma.from_EV(2.0, 4.0), GammaPrior.from_EV(2.0, 4.0)
    jp, tp = jmake_packer(jm), make_packer(tm)
    jobj = jfit.make_objective(jp, priors={"variance": jg, "lengthscale": jg,
                                           "likelihood_variance": jg})
    tobj = make_objective(tp, priors={"variance": tg, "lengthscale": tg,
                                      "likelihood_variance": tg})
    u0 = np.asarray(jp.pack(jm))
    key = jax.random.PRNGKey(7)
    js, jrate = jhmc.hmc_sample(lambda u: jobj(u, jm), jnp.asarray(u0), key, num_samples=5,
                                stepsize=0.1, leapfrog_steps=3)
    ts, trate = hmc.hmc_sample(lambda u: tobj(u[None], tm)[0], torch.tensor(u0), 5,
                               stepsize=0.1, leapfrog_steps=3,
                               draws=jax_hmc_draws(key, 5, u0.shape[0]))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-8, atol=1e-10)
    assert float(trate) == pytest.approx(float(jrate))


def test_hmc_rejects_a_nonfinite_proposal():
    """The NaN-proof accept: a potential that is NaN away from the start keeps
    the chain where it is."""
    def potential(u):
        return torch.where(torch.abs(u).sum() < 0.5, 0.5 * (u * u).sum(),
                           torch.tensor(float("nan"), dtype=u.dtype))

    momenta = torch.full((4, 2), 3.0, dtype=torch.float64)
    log_u = torch.full((4,), -1e-9, dtype=torch.float64)
    s, rate = hmc.hmc_sample(potential, torch.zeros(2, dtype=torch.float64), 4, stepsize=0.5,
                             leapfrog_steps=2, draws=(momenta, log_u))
    assert float(rate) == 0.0 and torch.equal(s, torch.zeros(4, 2, dtype=torch.float64))


def jax_mh_draws(key, num_samples, dim, tune_interval):
    """metropolis_hastings's draws (models/hmc.py:102-134): per tuning window a
    fresh split of the key, one key per step, and per step the proposal normal
    and the log of the accept uniform."""
    normals, log_u = [], []
    it = 0
    while it < num_samples:
        window = min(tune_interval, num_samples - it)
        key, sub = jax.random.split(key)
        pairs = jax.vmap(jax.random.split)(jax.random.split(sub, window))
        normals.append(np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (dim,), dtype=jnp.float64))(pairs[:, 0])))
        log_u.append(np.log(np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, dtype=jnp.float64))(pairs[:, 1]))))
        it += window
    return torch.tensor(np.concatenate(normals)), torch.tensor(np.concatenate(log_u))


@pytest.mark.parametrize("num_samples,burnin,thin,tune_throughout",
                         [(1100, 400, 5, False), (800, 200, 4, True)])
def test_metropolis_hastings_chain_matches_jax(num_samples, burnin, thin, tune_throughout):
    """The kept samples, the accept rate and the tuned scale and covariance,
    within 1e-8: two tuning windows then a short last one without tuning, or
    tuning throughout."""
    def logpost(lib, mu, prec):
        def f(u):
            d = u - mu
            return -0.5 * d @ prec @ d
        return f

    key = jax.random.PRNGKey(11)
    js, jrate, jscale, jcov = jhmc.metropolis_hastings(
        logpost(jnp, jnp.asarray(MU), jnp.asarray(PREC)), np.zeros(2), key,
        num_samples=num_samples, burnin=burnin, thin=thin, tune_interval=200,
        tune_throughout=tune_throughout)
    ts, trate, tscale, tcov = hmc.metropolis_hastings(
        logpost(torch, torch.tensor(MU), torch.tensor(PREC)),
        torch.zeros(2, dtype=torch.float64), num_samples=num_samples, burnin=burnin,
        thin=thin, tune_interval=200, tune_throughout=tune_throughout,
        draws=jax_mh_draws(key, num_samples, 2, 200))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-8, atol=1e-10)
    assert trate == pytest.approx(jrate, rel=1e-12)
    assert 0.05 < trate < 0.95
    assert tscale == pytest.approx(jscale, rel=1e-12)
    np.testing.assert_allclose(tcov, jcov, rtol=1e-8, atol=1e-10)


def jax_shortcut_draws(key, num_samples, dim):
    """hmc_shortcut_sample's draws (models/hmc.py:308-322): per sample the
    stepsize uniform, the momentum and the log of the accept uniform."""
    triples = jax.vmap(lambda k: jax.random.split(k, 3))(jax.random.split(key, num_samples))
    step_u = jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float64))(triples[:, 0])
    momenta = jax.vmap(lambda k: jax.random.normal(k, (dim,), dtype=jnp.float64))(triples[:, 1])
    log_u = np.log(np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, dtype=jnp.float64))(triples[:, 2])))
    return (torch.tensor(np.asarray(step_u)), torch.tensor(np.asarray(momenta)),
            torch.tensor(log_u))


@pytest.mark.parametrize("target,u0,stepsize_range,groupsize,steps", [
    ("gaussian", 0.0, (1e-3, 0.5), 5, 10),     # small steps trip the lower H-std bound
    ("stiff", 1.0, (0.05, 0.6), 3, 12),        # unstable steps reverse, then stop
    ("stiff", 1.0, (5.0, 10.0), 3, 12),        # diverges on the first steps
])
def test_hmc_shortcut_chain_matches_jax(target, u0, stepsize_range, groupsize, steps):
    """The shortcut sampler's chain, 25 samples, within 1e-8: the reversal with
    and without room and the stop on the second failure are all reached."""
    def potential(lib):
        if target == "gaussian":
            return _gaussian_potential(lib)
        return lambda u: 0.5 * lib.sum(lib.square(u)) * 50.0

    key = jax.random.PRNGKey(5)
    kw = dict(stepsize_range=stepsize_range, groupsize=groupsize, leapfrog_steps=steps)
    js, jrate = jhmc.hmc_shortcut_sample(potential(jnp), jnp.full(2, u0), key, 25, **kw)
    ts, trate = hmc.hmc_shortcut_sample(potential(torch),
                                        torch.full((2,), u0, dtype=torch.float64), 25,
                                        draws=jax_shortcut_draws(key, 25, 2), **kw)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-8, atol=1e-10)
    assert trate == pytest.approx(float(jrate), rel=1e-12)


def test_hmc_gaussian_moments():
    """(test_models_extra.py::test_hmc_sampler_gaussian_target) from the port's
    own generator."""
    gen = torch.Generator().manual_seed(0)
    s, rate = hmc.hmc_sample(_gaussian_potential(torch), torch.zeros(2, dtype=torch.float64),
                             1500, stepsize=0.3, leapfrog_steps=10, generator=gen)
    assert float(rate) > 0.6
    s = s[300:].numpy()
    np.testing.assert_allclose(s.mean(0), MU, atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), np.linalg.inv(PREC), atol=0.25)


def test_metropolis_hastings_gaussian_moments():
    """(test_models_extra.py::test_metropolis_hastings_gaussian_target)"""
    gen = torch.Generator().manual_seed(1)
    mu, prec = torch.tensor(MU), torch.tensor(PREC)

    def logpost(u):
        d = u - mu
        return -0.5 * d @ prec @ d

    samples, rate, scale, cov = hmc.metropolis_hastings(
        logpost, torch.zeros(2, dtype=torch.float64), num_samples=6000, burnin=1000, thin=5,
        tune_interval=400, generator=gen)
    assert 0.05 < rate < 0.95
    assert samples.shape[1] == 2 and samples.shape[0] > 500
    s = samples.numpy()
    np.testing.assert_allclose(s.mean(0), MU, atol=0.2)
    np.testing.assert_allclose(np.cov(s.T), np.linalg.inv(PREC), atol=0.35)
    assert np.trace(cov) < 10 * np.trace(np.linalg.inv(PREC))


def test_hmc_shortcut_gaussian_moments():
    """(test_models_extra.py::test_hmc_shortcut_gaussian_target): the shortcut
    sampler's moments agree with the analytic ones."""
    gen = torch.Generator().manual_seed(2)
    s, rate = hmc.hmc_shortcut_sample(_gaussian_potential(torch),
                                      torch.zeros(2, dtype=torch.float64), 800,
                                      stepsize_range=(1e-3, 0.5), groupsize=5,
                                      leapfrog_steps=10, generator=gen)
    assert rate > 0.5
    s = s[200:].numpy()
    np.testing.assert_allclose(s.mean(0), MU, atol=0.25)
    np.testing.assert_allclose(np.cov(s.T), np.linalg.inv(PREC), atol=0.4)


def test_hmc_shortcut_unstable_stepsize_stays_finite():
    """(test_models_extra.py::test_hmc_shortcut_unstable_stepsize_reverses): a
    huge step trips the H-std test; the reversal and wrap keep the chain finite
    and inside the explored segment."""
    gen = torch.Generator().manual_seed(3)

    def potential(u):
        return 0.5 * torch.sum(torch.square(u)) * 50.0

    s, _ = hmc.hmc_shortcut_sample(potential, torch.ones(2, dtype=torch.float64), 50,
                                   stepsize_range=(5.0, 10.0), groupsize=3,
                                   leapfrog_steps=12, generator=gen)
    assert np.all(np.isfinite(s.numpy())) and np.max(np.abs(s.numpy())) < 50.0

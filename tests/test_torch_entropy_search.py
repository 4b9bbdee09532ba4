"""The torch port's entropy search against the JAX package, in float64: the
ensemble sampler step by step under the reference's draws (reproduced from its
``jax.random`` keys and injected), EPMGP's ``joint_min`` and its derivatives
(and their finite differences, as ``tests/test_epmgp.py`` checks them), and both
entropy-search acquisitions on the same surrogate with the same representers
and normals (after ``tests/test_es_pool_serialization.py:22-70``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.bo import entropy_search as jes
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.epmgp import joint_min as jjoint_min
from gaussian_process_optimization_tpu.bo.mcmc_sampler import ensemble_sample as jensemble
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models.bo_models import GPModel as JGPModel
from gaussian_process_optimization_tpu_torch.bo import entropy_search as tes
from gaussian_process_optimization_tpu_torch.bo.epmgp import joint_min, pack_tril
from gaussian_process_optimization_tpu_torch.bo.mcmc_sampler import (
    AffineInvariantEnsembleSampler, EnsembleDraws, ensemble_sample)
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from torch_threads import one_torch_thread  # noqa: F401

F64 = jnp.float64


def jax_ensemble_draws(key, lower, upper, n_walkers, n_steps):
    """ensemble_sample's draws (bo/mcmc_sampler.py:24-70): the initial walkers,
    then per step and half-move the stretch uniforms, partners and log accept
    uniforms."""
    d, half = len(lower), n_walkers // 2
    k_init, k_run = jax.random.split(key)
    init = jax.random.uniform(k_init, (n_walkers, d), minval=jnp.asarray(lower),
                              maxval=jnp.asarray(upper), dtype=F64)
    u, partner, log_u = [], [], []
    for k in jax.random.split(k_run, n_steps):
        ka, kb = jax.random.split(k)
        rows = []
        for kk in (ka, kb):
            k1, k2, k3 = jax.random.split(kk, 3)
            rows.append((np.asarray(jax.random.uniform(k1, (half,), dtype=F64)),
                         np.asarray(jax.random.randint(k2, (half,), 0, n_walkers - half)),
                         np.log(np.asarray(jax.random.uniform(k3, (half,), dtype=F64)))))
        u.append([r[0] for r in rows])
        partner.append([r[1] for r in rows])
        log_u.append([r[2] for r in rows])
    return EnsembleDraws(init=torch.tensor(np.asarray(init)), u=torch.tensor(np.asarray(u)),
                         partner=torch.tensor(np.asarray(partner)),
                         log_u=torch.tensor(np.asarray(log_u)))


def _log_p(lib):
    centre = lib.asarray([1.0, -0.5]) if lib is jnp else torch.tensor([1.0, -0.5])

    def log_p(x):
        return -0.5 * lib.sum(lib.square((x - centre) / 0.7), -1)
    return log_p


def test_ensemble_chain_matches_jax():
    """8 walkers, 12 steps in [-1, 1]^2 around a mode at its edge, so that
    proposals leave the box and are refused."""
    lower, upper = np.array([-1.0, -1.0]), np.array([1.0, 1.0])
    key = jax.random.PRNGKey(5)
    jchain, jw = jensemble(_log_p(jnp), jnp.asarray(lower), jnp.asarray(upper), 8, 12, key)
    tchain, tw = ensemble_sample(_log_p(torch), torch.tensor(lower), torch.tensor(upper), 8, 12,
                                 draws=jax_ensemble_draws(key, lower, upper, 8, 12))
    np.testing.assert_allclose(tchain.numpy(), np.asarray(jchain), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-12, atol=1e-14)


def test_ensemble_sampler_gaussian():
    """(test_es_pool_serialization.py::test_ensemble_sampler_gaussian) from the
    port's own generator."""
    lower, upper = torch.tensor([-5.0, -5.0], dtype=torch.float64), torch.tensor(
        [5.0, 5.0], dtype=torch.float64)
    chain, _ = ensemble_sample(_log_p(torch), lower, upper, 64, 300,
                               generator=torch.Generator().manual_seed(0))
    s = chain[150:].reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(0), [1.0, -0.5], atol=0.1)
    np.testing.assert_allclose(s.std(0), [0.7, 0.7], atol=0.12)


def test_sampler_gpyopt_wrapper():
    """(test_es_pool_serialization.py::test_sampler_gpyopt_wrapper)"""
    sampler = AffineInvariantEnsembleSampler(DesignSpace(bounds_to_space([(0.0, 1.0)])),
                                             device="cpu")
    samples, logp = sampler.get_samples(10, lambda x: -np.sum((x - 0.5) ** 2, -1), 30)
    assert samples.shape == (10, 1) and logp.shape == (10, 1)
    assert np.all((samples >= 0) & (samples <= 1))


def _posterior_at_grid(seed, n_grid=6):
    """(test_epmgp.py::_posterior_at_grid) a GP's joint predictive at a grid,
    with the noise added, computed here in numpy."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (8, 1))
    Y = np.sin(1.5 * X[:, 0]) + 0.1 * rng.standard_normal(8)
    Xg = np.linspace(-2, 2, n_grid)[:, None]

    def k(a, b):
        return np.exp(-0.5 * (a - b.T) ** 2 / 0.49)
    Ky = k(X, X) + 0.05 * np.eye(8)
    Ks = k(X, Xg)
    mu = Ks.T @ np.linalg.solve(Ky, Y)
    cov = k(Xg, Xg) - Ks.T @ np.linalg.solve(Ky, Ks) + 0.05 * np.eye(n_grid)
    return mu, 0.5 * (cov + cov.T)


@pytest.mark.parametrize("case", ["grid0", "grid1", "wide", "separated"])
def test_joint_min_matches_jax(case):
    """logP and the three derivatives, 1e-8. 'separated' puts one point far
    below the others, so the z > 6 (inactive factor) branch is taken."""
    if case.startswith("grid"):
        mu, cov = _posterior_at_grid(int(case[-1]))
    else:
        rng = np.random.default_rng(7)
        A = rng.standard_normal((7, 7))
        cov = A @ A.T / 7 + 0.1 * np.eye(7)
        mu = rng.standard_normal(7)
        if case == "separated":
            mu[2] -= 40.0
    got = joint_min(torch.tensor(mu), torch.tensor(cov), with_derivatives=True)
    want = jjoint_min(jnp.asarray(mu), jnp.asarray(cov), with_derivatives=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-8 * np.abs(w).max())
    assert float(torch.logsumexp(got[0], 0)) == pytest.approx(0.0, abs=1e-12)


def test_joint_min_derivatives_match_fd():
    """(test_epmgp.py::test_joint_min_derivatives_match_fd and
    ::test_joint_min_dsigma_matches_fd) on the port's own joint_min."""
    mu, cov = _posterior_at_grid(3, n_grid=4)
    logP, dMu, dSig, _ = joint_min(torch.tensor(mu), torch.tensor(cov), with_derivatives=True)
    eps = 1e-5

    def lp(m, c):
        return joint_min(torch.tensor(m), torch.tensor(c)).numpy()

    fd = np.stack([(lp(mu + eps * e, cov) - lp(mu - eps * e, cov)) / (2 * eps)
                   for e in np.eye(4)], axis=1)
    np.testing.assert_allclose(dMu.numpy(), fd, atol=2e-3)
    ti, tj = np.tril_indices(4)
    for idx, (i, j) in enumerate(zip(ti, tj)):
        E = np.zeros((4, 4))
        E[i, j] = E[j, i] = eps
        fd_col = (lp(mu, cov + E) - lp(mu, cov - E)) / (2 * eps)
        np.testing.assert_allclose(dSig[:, idx].numpy(), fd_col, atol=5e-3)
    S = torch.tensor(cov)
    assert torch.equal(pack_tril(S), S[tuple(torch.tril_indices(4, 4))])


@pytest.fixture(scope="module")
def surrogates():
    """One GP surrogate in each package on the same data, unfitted (the
    initial parameters), so their posteriors agree."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, size=(12, 1))
    Y = np.asarray(objectives.forrester(X))
    Y = (Y - Y.mean()) / Y.std()
    theirs = JGPModel(exact_feval=True, max_iters=0)
    theirs.updateModel(X, Y)
    ours = GPModel(exact_feval=True, max_iters=0, device="cpu")
    ours.updateModel(X, Y)
    return theirs, ours


ES_SIZES = dict(num_representer_points=10, burn_in_steps=8)
XC = np.linspace(0.02, 0.98, 9)[:, None]


def _jax_es_draws(seed, n_steps, num_samples, R):
    """The reference acquisition's key use (entropy_search.py:72-94): one
    split for the sampler, then the normals W and w_f."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    walkers = jax_ensemble_draws(sub, [0.0], [1.0], R + R % 2, n_steps)
    key, sub = jax.random.split(key)
    W = np.asarray(jax.random.normal(sub, (num_samples, R), dtype=F64))
    key, sub = jax.random.split(key)
    w_f = np.asarray(jax.random.normal(sub, (num_samples,), dtype=F64))
    return {"walkers": walkers, "W": W, "w_f": w_f}


def test_entropy_search_mc_matches_jax(surrogates):
    theirs, ours = surrogates
    space = bounds_to_space([(0.0, 1.0)])
    jacq = jes.AcquisitionEntropySearch(theirs, JSpace(space), num_samples=60, **ES_SIZES)
    tacq = tes.AcquisitionEntropySearch(ours, DesignSpace(space), num_samples=60, **ES_SIZES)
    jacq._update_representers()
    tacq._update_representers(_jax_es_draws(0, 8, 60, 10))
    _, _, jZ, jmu, jLz, jW, jwf = jacq._state
    Z, muZ, Lz, W, w_f, _, _ = tacq._state
    np.testing.assert_allclose(Z.numpy(), np.asarray(jZ), rtol=1e-12)
    # the representers cluster, so their joint covariance is nearly singular:
    # Lz's small entries carry the rounding of its large ones
    np.testing.assert_allclose(Lz.numpy(), np.asarray(jLz), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(jLz)).max())
    got, want = tacq._compute_acq(XC), np.asarray(jacq._compute_acq(XC))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)
    assert got.shape == (9, 1) and np.all(np.isfinite(got))


def test_entropy_search_epmgp_matches_jax(surrogates):
    theirs, ours = surrogates
    space = bounds_to_space([(0.0, 1.0)])
    jacq = jes.AcquisitionEntropySearchEPMGP(theirs, JSpace(space), num_samples=50, **ES_SIZES)
    tacq = tes.AcquisitionEntropySearchEPMGP(ours, DesignSpace(space), num_samples=50,
                                             **ES_SIZES)
    jacq._update_representers()
    tacq._update_representers({"walkers": _jax_es_draws(0, 8, 50, 10)["walkers"]})
    jstate = jacq._state
    for got, want in zip(tacq._state, jstate[2:]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-8 * np.abs(want).max())
    got, want = tacq._compute_acq(XC), np.asarray(jacq._compute_acq(XC))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("cls", ["AcquisitionEntropySearch", "AcquisitionEntropySearchEPMGP"])
def test_entropy_search_optimize(surrogates, cls):
    """(test_es_pool_serialization.py::test_entropy_search_acquisition): the
    argmax refreshes the representers and keeps the sweep's anchors (no
    gradient); the information gain is finite."""
    _, ours = surrogates
    space = DesignSpace(bounds_to_space([(0.0, 1.0)]))
    opt = AcquisitionOptimizer(space, num_samples=100, num_anchor=3)
    es = getattr(tes, cls)(ours, space, opt, **ES_SIZES)
    vals = es._compute_acq(XC)
    assert vals.shape == (9, 1) and np.all(np.isfinite(vals))
    state = es._state
    x, fx = es.optimize()
    assert es._state is not state
    assert x.shape == (1, 1) and 0 <= x[0, 0] <= 1 and np.isfinite(fx).all()

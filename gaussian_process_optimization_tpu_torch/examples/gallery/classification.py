"""Classification gallery (twin of ``examples/gallery/classification.py``; GPy
examples/classification.py).

EP probit classification (dense, and sparse EPDTC), Laplace inference and the
uncertain-input sparse classifier. ``oil`` and ``crescent_data`` use the
reference's synthetic stand-ins for the downloaded datasets.
"""
import numpy as np

from ... import kernels as kern
from ...kernels.base import placement
from ...models.classification import (
    GPClassification,
    SparseGPClassification,
    SparseGPClassificationUncertainInput,
)
from .._util import generator, to_numpy

default_seed = 10000


def _two_moons(n, seed, spread=0.25):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, np.pi, n)
    upper = np.stack([np.cos(t), np.sin(t)], 1)
    lower = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], 1)
    X = np.vstack([upper, lower]) + spread * rng.standard_normal((2 * n, 2))
    y = np.hstack([np.ones(n), -np.ones(n)])
    return X, y


def oil(num_inducing=15, max_iters=40, kernel=None, optimize=True, plot=False, device=None,
        dtype=None):
    """GPy examples/classification.py:10: sparse EP classification on the oil
    flow data (synthetic: two overlapping 12-D Gaussian classes)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(0)
    n = 60
    X = np.vstack([rng.standard_normal((n, 12)) - 0.7,
                   rng.standard_normal((n, 12)) + 0.7])
    y = np.hstack([np.ones(n), -np.ones(n)])
    m = SparseGPClassification.create(
        X, y, kernel=kernel or kern.RBF.create(12, **new), num_inducing=num_inducing, **new)
    if optimize:
        m, _ = m.optimize(rounds=2, maxiter=max_iters)
    acc = np.mean((to_numpy(m.predict(X)) > 0.5) == (y > 0))
    assert acc > 0.7, f"oil demo accuracy {acc}"
    return m


def toy_linear_1d_classification(seed=default_seed, optimize=True, plot=False, device=None,
                                 dtype=None):
    """GPy examples/classification.py:43: 1-D EP probit classification."""
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(1, 0.5, (25, 1)), rng.normal(3, 0.5, (25, 1))])
    y = np.hstack([-np.ones(25), np.ones(25)])
    m = GPClassification.create(X, y, **new)
    if optimize:
        m, _ = m.optimize(rounds=2, maxiter=30)
    if plot:
        from ...utils.plotting_library import plot_mean

        plot_mean(m, filename="toy_linear_1d_classification.png")
    return m


def toy_linear_1d_classification_laplace(seed=default_seed, optimize=True, plot=False,
                                         device=None, dtype=None):
    """GPy examples/classification.py:78: the Laplace-inference variant."""
    from ...models import fit as fit_mod
    from ...models.laplace import GPLaplace
    from ...models.likelihoods import Bernoulli

    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(1, 0.5, (25, 1)), rng.normal(3, 0.5, (25, 1))])
    y = np.hstack([-np.ones(25), np.ones(25)])
    m = GPLaplace.create(X, y, kernel=kern.RBF.create(1, **new), likelihood=Bernoulli(), **new)
    if optimize:
        m, _ = fit_mod.fit(m, num_restarts=1, maxiter=30,
                           generator=generator(0, new["device"]))
    assert np.isfinite(float(m.log_marginal_likelihood()))
    return m


def sparse_toy_linear_1d_classification(num_inducing=10, seed=default_seed, optimize=True,
                                        plot=False, device=None, dtype=None):
    """GPy examples/classification.py:117: sparse EPDTC on the 1-D toy."""
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(1, 0.5, (30, 1)), rng.normal(3, 0.5, (30, 1))])
    y = np.hstack([-np.ones(30), np.ones(30)])
    m = SparseGPClassification.create(X, y, num_inducing=num_inducing, **new)
    if optimize:
        m, _ = m.optimize(rounds=2, maxiter=30)
    return m


def sparse_toy_linear_1d_classification_uncertain_input(
        num_inducing=10, seed=default_seed, optimize=True, plot=False, device=None,
        dtype=None):
    """GPy examples/classification.py:150: noisy inputs through the
    psi-statistics EPDTC path."""
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.normal(1, 0.5, (30, 1)), rng.normal(3, 0.5, (30, 1))])
    X_var = 0.04 * np.ones_like(X)
    y = np.hstack([-np.ones(30), np.ones(30)])
    m = SparseGPClassificationUncertainInput.create(X, X_var, y, num_inducing=num_inducing,
                                                    **new)
    if optimize:
        m, _ = m.optimize(rounds=2, maxiter=30)
    return m


def toy_heaviside(seed=default_seed, max_iters=30, optimize=True, plot=False, device=None,
                  dtype=None):
    """GPy examples/classification.py:186: EP with a step decision boundary."""
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (60, 1))
    y = np.where(X[:, 0] > 0.3, 1.0, -1.0)
    flip = rng.uniform(size=60) < 0.05
    y = np.where(flip, -y, y)
    m = GPClassification.create(X, y, kernel=kern.Matern52.create(1, **new), **new)
    if optimize:
        m, _ = m.optimize(rounds=2, maxiter=max_iters)
    return m


def crescent_data(model_type="Full", num_inducing=10, seed=default_seed, kernel=None,
                  optimize=True, plot=False, device=None, dtype=None):
    """GPy examples/classification.py:225: the two crescents, dense or sparse by
    ``model_type`` ('Full' | 'DTC')."""
    new = placement(dtype, device)
    X, y = _two_moons(30, seed)
    kernel = kernel or kern.RBF.create(2, **new)
    if model_type == "Full":
        m = GPClassification.create(X, y, kernel=kernel, **new)
    else:
        m = SparseGPClassification.create(X, y, kernel=kernel, num_inducing=num_inducing,
                                          **new)
    if optimize:
        m, _ = m.optimize(rounds=2, maxiter=30)
    acc = np.mean((to_numpy(m.predict(X)) > 0.5) == (y > 0))
    assert acc > 0.75, f"crescent demo accuracy {acc}"
    return m

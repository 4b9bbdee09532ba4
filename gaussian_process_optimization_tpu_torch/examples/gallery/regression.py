"""Regression gallery (twin of ``examples/gallery/regression.py``; GPy
examples/regression.py).

Every demo returns a model and takes ``(optimize, plot, max_iters)`` like the
reference, plus ``device`` and ``dtype``. Dataset-backed demos (olympic
marathon / 100m, epomeo GPX, della gatta gene, robot wireless, silhouette) use
the reference's synthetic stand-ins. Fits are multi-restart L-BFGS
(``models/fit.py``); ``max_iters`` bounds the L-BFGS steps.
"""
import numpy as np
import torch

from ... import kernels as kern
from ...kernels.base import placement
from ...models import GPRegression, SparseGPRegression, fit as fit_mod
from ...models.mean_functions import Constant, LinearMapping
from .._util import generator


def _fit(m, optimize, max_iters, device, restarts=1, seed=0):
    if not optimize:
        return m
    fitted, _ = fit_mod.fit(m, num_restarts=restarts, maxiter=max_iters,
                            generator=generator(seed, device))
    return fitted


def _maybe_plot(m, plot, name):
    if plot:
        m.plot(filename=f"{name}.png")
    return m


def olympic_marathon_men(optimize=True, plot=False, max_iters=150, device=None, dtype=None):
    """GPy examples/regression.py:14: RBF + bias on the olympic marathon data;
    synthetic stand-in: a decaying trend over 27 games."""
    new = placement(dtype, device)
    years = np.linspace(1896, 2012, 27)[:, None]
    rng = np.random.default_rng(0)
    pace = 2.8 + 1.4 * np.exp(-(years - 1896) / 40.0) \
        + 0.08 * rng.standard_normal(years.shape)
    X = (years - years.mean()) / years.std()
    m = GPRegression.create(
        X, pace, kernel=kern.RBF.create(1, **new) + kern.Bias.create(1, **new),
        noise_var=0.05, **new)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "olympic_marathon_men")


def olympic_100m_men(optimize=True, plot=False, max_iters=150, device=None, dtype=None):
    """GPy examples/regression.py:218: the same on the sprint data (synthetic)."""
    new = placement(dtype, device)
    years = np.linspace(1896, 2012, 27)[:, None]
    rng = np.random.default_rng(1)
    t = 9.6 + 1.2 * np.exp(-(years - 1896) / 55.0) \
        + 0.07 * rng.standard_normal(years.shape)
    X = (years - years.mean()) / years.std()
    m = GPRegression.create(
        X, t, kernel=kern.RBF.create(1, **new) + kern.Bias.create(1, **new),
        noise_var=0.05, **new)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "olympic_100m_men")


def toy_rbf_1d(optimize=True, plot=False, max_iters=100, device=None, dtype=None):
    """GPy examples/regression.py:239: RBF GP on the toy sine."""
    new = placement(dtype, device)
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (40, 1))
    Y = np.sin(6 * X) + 0.1 * rng.standard_normal(X.shape)
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.05, **new)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "toy_rbf_1d")


def toy_rbf_1d_50(optimize=True, plot=False, max_iters=100, device=None, dtype=None):
    """GPy examples/regression.py:257: the 50-point variant."""
    new = placement(dtype, device)
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (50, 1))
    Y = np.sin(6 * X) + 0.1 * rng.standard_normal(X.shape)
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.05, **new)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "toy_rbf_1d_50")


def toy_poisson_rbf_1d_laplace(optimize=True, plot=False, max_iters=60, device=None,
                               dtype=None):
    """GPy examples/regression.py:275: Poisson counts through Laplace inference."""
    from ...models.laplace import GPLaplace
    from ...models.likelihoods import Poisson

    new = placement(dtype, device)
    rng = np.random.default_rng(4)
    X = np.linspace(0, 6, 40)[:, None]
    rate = np.exp(1.0 + np.sin(X[:, 0]))
    Y = rng.poisson(rate).astype(float)
    m = GPLaplace.create(X, Y, kernel=kern.RBF.create(1, **new), likelihood=Poisson(), **new)
    m = _fit(m, optimize, max_iters, new["device"])
    assert np.isfinite(float(m.log_marginal_likelihood()))
    return m


def toy_ARD(optimize=True, plot=False, max_iters=150, kernel_type="linear",
            num_samples=80, D=4, device=None, dtype=None):
    """GPy examples/regression.py:299: ARD relevance; the output depends on 3
    of 4 inputs."""
    new = placement(dtype, device)
    rng = np.random.default_rng(5)
    X = rng.uniform(-np.pi, np.pi, (num_samples, D))
    Y = (np.sin(X[:, :1]) + 0.5 * np.cos(3 * X[:, 1:2]) + X[:, 2:3] ** 2
         + 0.05 * rng.standard_normal((num_samples, 1)))
    k = (kern.Linear.create(D, ARD=True, **new) + kern.Bias.create(D, **new)
         if kernel_type == "linear" else kern.RBF.create(D, ARD=True, **new))
    m = GPRegression.create(X, Y, kernel=k, noise_var=0.1, **new)
    return _fit(m, optimize, max_iters, new["device"])


def toy_ARD_sparse(optimize=True, plot=False, max_iters=150, kernel_type="linear",
                   num_samples=80, D=4, device=None, dtype=None):
    """GPy examples/regression.py:337: the sparse (inducing-point) variant."""
    new = placement(dtype, device)
    rng = np.random.default_rng(6)
    X = rng.uniform(-np.pi, np.pi, (num_samples, D))
    Y = (np.sin(X[:, :1]) + 0.5 * np.cos(3 * X[:, 1:2]) + X[:, 2:3] ** 2
         + 0.05 * rng.standard_normal((num_samples, 1)))
    k = (kern.Linear.create(D, ARD=True, **new) + kern.Bias.create(D, **new)
         if kernel_type == "linear" else kern.RBF.create(D, ARD=True, **new))
    m = SparseGPRegression.create(X, Y, kernel=k, num_inducing=12, noise_var=0.1, **new)
    return _fit(m, optimize, max_iters, new["device"])


def multiple_optima(optimize=True, plot=False, max_iters=80, model_restarts=4,
                    seed=10000, device=None, dtype=None):
    """GPy examples/regression.py:125: the RBF LML of a short noisy series has
    several local optima; the multi-start fit keeps the best lane (synthetic
    stand-in for the della gatta gene series)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 1, 12)[:, None]
    Y = np.sin(10 * X) * np.exp(-2 * X) + 0.05 * rng.standard_normal(X.shape)
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.05, **new)
    m = _fit(m, optimize, max_iters, new["device"], restarts=model_restarts)
    return _maybe_plot(m, plot, "multiple_optima")


def epomeo_gpx(optimize=True, plot=False, max_iters=100, device=None, dtype=None):
    """GPy examples/regression.py:83: a GP over a GPS track (five laps;
    synthetic loop plus altitude profile against time)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(7)
    t = np.linspace(0, 5, 120)[:, None]
    lat = np.sin(2 * np.pi * t) * (1 + 0.02 * rng.standard_normal(t.shape))
    lon = np.cos(2 * np.pi * t) * (1 + 0.02 * rng.standard_normal(t.shape))
    alt = 300 + 80 * np.sin(np.pi * (t % 1.0)) + 2 * rng.standard_normal(t.shape)
    Y = np.hstack([lat, lon, alt / 100.0])
    m = GPRegression.create(t, Y, kernel=kern.Matern52.create(1, **new), noise_var=0.01,
                            **new)
    return _fit(m, optimize, max_iters, new["device"])


def robot_wireless(optimize=True, plot=False, max_iters=80, device=None, dtype=None):
    """GPy examples/regression.py:376: WiFi signal strengths along a robot path
    (synthetic: 3 access points, log-distance path loss)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(8)
    path = np.linspace(0, 2 * np.pi, 100)[:, None]
    pos = np.hstack([np.cos(path), np.sin(path)])
    aps = np.array([[0.0, 0.0], [1.5, 0.5], [-1.0, 1.0]])
    d = np.linalg.norm(pos[:, None, :] - aps[None], axis=-1)
    Y = -30 - 20 * np.log10(d + 0.1) + 0.5 * rng.standard_normal(d.shape)
    m = GPRegression.create(path, Y / 10.0, kernel=kern.RBF.create(1, **new),
                            noise_var=0.05, **new)
    return _fit(m, optimize, max_iters, new["device"])


def silhouette(optimize=True, plot=False, max_iters=80, device=None, dtype=None):
    """GPy examples/regression.py:404: multi-output regression, silhouette
    features -> pose (synthetic: 10-D features, 3-D pose)."""
    new = placement(dtype, device)
    rng = np.random.default_rng(9)
    Z = rng.standard_normal((60, 10))
    W = rng.standard_normal((10, 3)) / np.sqrt(10)
    Y = np.tanh(Z @ W) + 0.05 * rng.standard_normal((60, 3))
    m = GPRegression.create(Z, Y, kernel=kern.RBF.create(10, **new), noise_var=0.05, **new)
    return _fit(m, optimize, max_iters, new["device"])


def coregionalization_toy(optimize=True, plot=False, max_iters=100, device=None,
                          dtype=None):
    """GPy examples/regression.py:35: two correlated outputs through the ICM
    coregionalized kernel (B (x) K)."""
    from ...models.multioutput import GPCoregionalizedRegression

    new = placement(dtype, device)
    rng = np.random.default_rng(10)
    X1 = rng.uniform(0, 10, (30, 1))
    X2 = rng.uniform(0, 10, (25, 1))
    Y1 = np.sin(X1) + 0.1 * rng.standard_normal(X1.shape)
    Y2 = np.sin(X2) + 0.6 + 0.1 * rng.standard_normal(X2.shape)
    m = GPCoregionalizedRegression([X1, X2], [Y1, Y2], **new)
    if optimize:
        m.optimize(num_restarts=1, maxiter=max_iters)
    return m


def coregionalization_sparse(optimize=True, plot=False, max_iters=100, device=None,
                             dtype=None):
    """GPy examples/regression.py:58: the sparse coregionalized variant."""
    from ...models.multioutput import SparseGPCoregionalizedRegression

    new = placement(dtype, device)
    rng = np.random.default_rng(11)
    X1 = rng.uniform(0, 10, (40, 1))
    X2 = rng.uniform(0, 10, (35, 1))
    Y1 = np.sin(X1) + 0.1 * rng.standard_normal(X1.shape)
    Y2 = np.sin(X2) + 0.6 + 0.1 * rng.standard_normal(X2.shape)
    m = SparseGPCoregionalizedRegression([X1, X2], [Y1, Y2], num_inducing=8, **new)
    if optimize:
        m.optimize(num_restarts=1, maxiter=max_iters)
    return m


def sparse_GP_regression_1D(num_samples=120, num_inducing=5, max_iters=100,
                            optimize=True, plot=False, checkgrad=False, device=None,
                            dtype=None):
    """GPy examples/regression.py:422: a 1-D sparse GP with 5 inducing points."""
    new = placement(dtype, device)
    rng = np.random.default_rng(12)
    X = rng.uniform(-3, 3, (num_samples, 1))
    Y = np.sin(X) + 0.05 * rng.standard_normal(X.shape)
    m = SparseGPRegression.create(X, Y, kernel=kern.RBF.create(1, **new),
                                  num_inducing=num_inducing, noise_var=0.05, **new)
    if checkgrad:
        assert fit_mod.checkgrad(m)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "sparse_GP_regression_1D")


def sparse_GP_regression_2D(num_samples=150, num_inducing=16, max_iters=100,
                            optimize=True, plot=False, nan=False, device=None, dtype=None):
    """GPy examples/regression.py:443: a 2-D sparse GP; ``nan`` drops a fifth
    of the observations."""
    new = placement(dtype, device)
    rng = np.random.default_rng(13)
    X = rng.uniform(-3, 3, (num_samples, 2))
    Y = np.sin(X[:, :1]) * np.cos(X[:, 1:]) + 0.05 * rng.standard_normal((num_samples, 1))
    if nan:
        keep = rng.uniform(size=num_samples) > 0.2
        X, Y = X[keep], Y[keep]
    m = SparseGPRegression.create(X, Y, kernel=kern.RBF.create(2, ARD=True, **new),
                                  num_inducing=num_inducing, noise_var=0.05, **new)
    return _fit(m, optimize, max_iters, new["device"])


def uncertain_inputs_sparse_regression(max_iters=100, optimize=True, plot=False,
                                       device=None, dtype=None):
    """GPy examples/regression.py:474: the sparse bound with input variance
    (through the psi statistics)."""
    from ...models.gplvm import uncertain_input_bound

    new = placement(dtype, device)
    rng = np.random.default_rng(14)
    X = np.linspace(-3, 3, 60)[:, None]
    X_var = 0.09 * np.ones_like(X)
    Y = np.sin(X) + 0.05 * rng.standard_normal(X.shape)
    k = kern.RBF.create(1, **new)
    Z = np.linspace(-3, 3, 9)[:, None]
    bound = uncertain_input_bound(k, *(torch.as_tensor(a, **new)
                                       for a in (Z, 0.05, Y, X, X_var)))
    assert np.isfinite(float(bound))
    return bound


def simple_mean_function(max_iters=100, optimize=True, plot=False, device=None,
                         dtype=None):
    """GPy examples/regression.py:509: a GP over a linear mean mapping."""
    new = placement(dtype, device)
    rng = np.random.default_rng(15)
    X = np.linspace(0, 10, 50)[:, None]
    Y = np.sin(X) + 0.5 * X + 0.1 * rng.standard_normal(X.shape)
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.05,
                            mean_function=LinearMapping.create(1, 1, **new), **new)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "simple_mean_function")


def parametric_mean_function(max_iters=100, optimize=True, plot=False, device=None,
                             dtype=None):
    """GPy examples/regression.py:530: a trainable constant + linear mean under
    the GP."""
    from ...models.mean_functions import Additive

    new = placement(dtype, device)
    rng = np.random.default_rng(16)
    X = np.linspace(0, 10, 50)[:, None]
    Y = 2.0 + 0.3 * X + np.sin(X) + 0.1 * rng.standard_normal(X.shape)
    mf = Additive(m1=Constant.create(1, value=0.0, **new), m2=LinearMapping.create(1, 1, **new))
    m = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.05,
                            mean_function=mf, **new)
    return _fit(m, optimize, max_iters, new["device"])


def warped_gp_cubic_sine(max_iters=100, optimize=True, plot=False, device=None, dtype=None):
    """GPy examples/regression.py:553: a warped GP on a cubic-sine warp."""
    from ...models.warped import WarpedGP

    new = placement(dtype, device)
    rng = np.random.default_rng(17)
    X = rng.uniform(-3, 3, (60, 1))
    f = np.sin(X)
    Y = (f + 0.05 * rng.standard_normal(X.shape)) ** 3 + f
    m = WarpedGP.create(X, Y, kernel=kern.RBF.create(1, **new), warping_terms=2, **new)
    m = _fit(m, optimize, max_iters, new["device"])
    return _maybe_plot(m, plot, "warped_gp_cubic_sine")

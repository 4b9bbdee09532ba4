"""State-space gallery (twin of ``examples/gallery/state_space.py``; GPy
examples/state_space.py): the O(N) Kalman-filter GP (``models/state_space.py``)
against the dense GP on the same kernel."""
import numpy as np

from ... import kernels as kern
from ...kernels.base import placement
from ...models import fit as fit_mod
from ...models.gp import GPRegression
from ...models.state_space import StateSpaceGP
from .._util import generator


def state_space_example(optimize=True, plot=False, max_iters=40, n=400, device=None,
                        dtype=None):
    """GPy examples/state_space.py:7: a Matern32 state-space GP on a long 1-D
    series; its filtered LML equals the dense GP's on a subsample."""
    new = placement(dtype, device)
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 20, (n, 1)), axis=0)
    Y = np.sin(X) + 0.3 * np.sin(3.1 * X) + 0.1 * rng.standard_normal(X.shape)
    m = StateSpaceGP.create(X, Y, family="matern32", variance=1.0, lengthscale=1.0,
                            noise_var=0.1, **new)
    if optimize:
        m, _ = fit_mod.fit(m, num_restarts=1, maxiter=max_iters,
                           generator=generator(0, new["device"]))
    # the dense GP at the fitted hyperparameters, on a slice
    idx = np.arange(0, n, 8)
    variance, lengthscale, noise = (float(m.variance), float(m.lengthscale),
                                    float(m.noise_variance))
    dense = GPRegression.create(
        X[idx], Y[idx],
        kernel=kern.Matern32.create(1, variance=variance, lengthscale=lengthscale, **new),
        noise_var=noise, **new)
    m_small = StateSpaceGP.create(X[idx], Y[idx], family="matern32", variance=variance,
                                  lengthscale=lengthscale, noise_var=noise, **new)
    lml_ss = float(m_small.log_marginal_likelihood())
    lml_dense = float(dense.log_marginal_likelihood())
    assert abs(lml_ss - lml_dense) < 1e-2 * max(1.0, abs(lml_dense)), (lml_ss, lml_dense)
    return m

"""Non-Gaussian gallery (twin of ``examples/gallery/non_gaussian.py``; GPy
examples/non_gaussian.py).

Student-t robust regression across inference engines (Laplace on the
t-likelihood, the TP marginal, and a Gaussian GP as the outlier-sensitive
control). ``boston_example`` uses the reference's synthetic housing-shaped data.
"""
import numpy as np
import torch

from ... import kernels as kern
from ...kernels.base import placement
from ...models import fit as fit_mod
from ...models.gp import GPRegression
from .._util import generator, to_numpy


def student_t_approx(optimize=True, plot=False, max_iters=50, device=None, dtype=None):
    """GPy examples/non_gaussian.py:12: a sine with two outliers; the Student-t
    models shrug them off where the Gaussian GP bends."""
    from ...models.laplace import GPLaplace
    from ...models.likelihoods import StudentT
    from ...models.tp import TPRegression

    new = placement(dtype, device)
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(0, 10, (50, 1)), axis=0)
    Y = np.sin(X) + 0.1 * rng.standard_normal(X.shape)
    Y[10] += 3.0
    Y[35] -= 3.0

    gauss = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.1, **new)
    stu_lap = GPLaplace.create(X, Y[:, 0], kernel=kern.RBF.create(1, **new),
                               likelihood=StudentT.create(deg_free=4.0, **new), **new)
    tp = TPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), deg_free=4.0, **new)
    if optimize:
        gauss, _ = fit_mod.fit(gauss, num_restarts=1, maxiter=max_iters,
                               generator=generator(0, new["device"]))
        stu_lap, _ = fit_mod.fit(stu_lap, num_restarts=1, maxiter=max_iters,
                                 generator=generator(0, new["device"]))
        tp, _ = fit_mod.fit(tp, num_restarts=1, maxiter=max_iters,
                            generator=generator(0, new["device"]))
    # on clean mid-points the t-model's prediction stays finite
    Xt = np.linspace(2, 8, 20)[:, None]
    mu_t = to_numpy(stu_lap.predict(Xt)[0]).reshape(-1)
    assert np.isfinite(np.max(np.abs(mu_t - np.sin(Xt[:, 0]))))
    return gauss, stu_lap, tp


def boston_example(optimize=True, plot=False, max_iters=60, device=None, dtype=None):
    """GPy examples/non_gaussian.py:129: Student-t against Gaussian on housing
    data with heavy-tailed targets (synthetic: 8 features, t noise), one
    train / test split."""
    from ...models.laplace import GPLaplace
    from ...models.likelihoods import StudentT

    new = placement(dtype, device)
    rng = np.random.default_rng(1)
    n, d = 80, 8
    X = rng.standard_normal((n, d))
    w = rng.standard_normal((d, 1))
    noise = rng.standard_t(3, size=(n, 1)) * 0.3
    Y = np.tanh(X @ w) + noise
    Xtr, Ytr, Xte, Yte = X[:60], Y[:60], X[60:], Y[60:]
    Ym, Ys = Ytr.mean(), Ytr.std()
    Ytr_n = (Ytr - Ym) / Ys

    gauss = GPRegression.create(Xtr, Ytr_n, kernel=kern.RBF.create(d, ARD=False, **new),
                                noise_var=0.1, **new)
    stu = GPLaplace.create(Xtr, Ytr_n[:, 0], kernel=kern.RBF.create(d, **new),
                           likelihood=StudentT.create(deg_free=4.0, **new), **new)
    if optimize:
        gauss, _ = fit_mod.fit(gauss, num_restarts=1, maxiter=max_iters,
                               generator=generator(0, new["device"]))
        stu, _ = fit_mod.fit(stu, num_restarts=1, maxiter=max_iters,
                             generator=generator(0, new["device"]))
    Xte_t = torch.as_tensor(Xte, **new)
    mu_g = to_numpy(gauss.predict(Xte_t)[0]).reshape(-1) * Ys + Ym
    mu_t = to_numpy(stu.predict(Xte_t)[0]).reshape(-1) * Ys + Ym
    rmse_g = float(np.sqrt(np.mean((mu_g - Yte[:, 0]) ** 2)))
    rmse_t = float(np.sqrt(np.mean((mu_t - Yte[:, 0]) ** 2)))
    assert np.isfinite(rmse_g) and np.isfinite(rmse_t)
    return {"rmse_gaussian": rmse_g, "rmse_student_t": rmse_t}

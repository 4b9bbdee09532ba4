"""Predictive uncertainty (twin of ``examples/uncertainty_quantification.py``):
quantile bands, predictive density scoring, posterior derivatives, and
non-Gaussian predictive quantiles, on four model families: the exact GP, the
Student-t process, the warped GP (positive targets) and a Poisson SVGP (GPy
core/gp.py:384-714; likelihoods/likelihood.py:757, :769).

Run: python -m gaussian_process_optimization_tpu_torch.examples.uncertainty_quantification
"""
import numpy as np
import torch

from .. import kernels as kern
from ..kernels.base import placement
from ..models import fit as fit_mod
from ..models import likelihoods as lik
from ..models.gp import GPRegression
from ..models.svgp import SVGP, fit_svgp
from ..models.tp import TPRegression
from ..models.warped import LogWarp, WarpedGP
from ._util import generator, to_numpy


def main(seed=0, device=None, dtype=None):
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (40, 1))
    f = np.sin(2 * X)
    Xs = np.linspace(-2, 2, 9)[:, None]
    Xs_t = torch.as_tensor(Xs, **new)

    # exact GP: quantile bands and the held-out log predictive density
    Y = f + 0.15 * rng.standard_normal(X.shape)
    m, _ = fit_mod.fit(GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), **new),
                       num_restarts=2, maxiter=200,
                       generator=generator(seed, new["device"]))
    lo, med, hi = m.predict_quantiles(Xs_t, quantiles=(2.5, 50, 97.5))
    lpd = m.log_predictive_density(Xs_t, torch.as_tensor(np.sin(2 * Xs), **new))
    print("GP   95% band width:", np.round(to_numpy(hi - lo).ravel(), 2))
    print("GP   mean held-out LPD:", float(np.mean(to_numpy(lpd))))

    # the posterior derivative: where the fitted surface is steep or uncertain
    mean_jac, var_jac = m.predict_jacobian(Xs_t)
    print("GP   E[df/dx]:", np.round(to_numpy(mean_jac)[:, 0, 0], 2))
    print("GP   sd[df/dx]:", np.round(np.sqrt(to_numpy(var_jac)[:, 0, 0]), 2))

    # Student-t process: heavier predictive tails than the GP. The TP has no
    # Gaussian noise term (GPy tp_regression.py): a White kernel gives it the
    # GP's noise floor
    mt = TPRegression.create(
        X, Y, kernel=m.kern + kern.White.create(1, variance=float(m.likelihood_variance),
                                                **new),
        deg_free=4.0, **new)
    tlo, thi = mt.predict_quantiles(Xs_t)
    print("TP   95% vs GP band ratio:",
          np.round(to_numpy(thi - tlo).ravel() / to_numpy(hi - lo).ravel(), 3))

    # warped GP on positive targets: its bands keep to the support
    Ypos = np.exp(0.8 * f) * (1 + 0.1 * rng.standard_normal(X.shape))
    mw = WarpedGP.create(X, Ypos, kernel=kern.RBF.create(1, **new), noise_var=0.05,
                         warping_function=LogWarp(), **new)
    wlo, whi = mw.predict_quantiles(Xs_t)
    print("Warp lower band min (must be > 0):", float(to_numpy(wlo).min()))

    # Poisson SVGP: count quantiles through the sampling fallback
    Yc = rng.poisson(np.exp(1.2 * f)).astype(float)
    sv = SVGP.create(X, Yc, Z=X[::5], kernel=kern.RBF.create(1, **new),
                     likelihood=lik.Poisson(), **new)
    sv, _ = fit_svgp(sv, X, Yc, num_steps=200,
                     generator=generator(seed, new["device"]))
    q10, q90 = sv.predict_quantiles(Xs_t, quantiles=(10, 90), rng=np.random.default_rng(1))
    print("Pois 10/90% count band:", list(zip(to_numpy(q10).ravel(), to_numpy(q90).ravel())))
    return m, mt, mw, sv


if __name__ == "__main__":
    main()

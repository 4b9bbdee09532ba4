"""Past the exact-GP wall (twin of ``examples/large_scale_sparse.py``;
BASELINE config 4): sparse VarDTC and minibatch SVGP at N = 50 000 synthetic
points.

Run: python -m gaussian_process_optimization_tpu_torch.examples.large_scale_sparse
"""
import time

import numpy as np
import torch

from .. import kernels as kern
from ..kernels.base import placement
from ..models import fit as fit_mod
from ..models.sparse import SparseGPRegression
from ..models.svgp import SVGP, fit_svgp
from ._util import generator, to_numpy


def main(n=50_000, m=256, seed=0, svgp_steps=300, device=None, dtype=None):
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, size=(n, 2))
    Y = np.sin(X[:, :1] * 2) * np.cos(X[:, 1:]) + 0.1 * rng.standard_normal((n, 1))

    k = kern.RBF.create(2, variance=1.0, lengthscale=1.0, **new)

    t0 = time.time()
    sgp = SparseGPRegression.create(X, Y, kernel=k, num_inducing=m, noise_var=0.05, **new)
    bound = float(sgp.log_marginal_likelihood())
    print(f"VarDTC bound @ N={n}, M={m}: {bound:.1f}  ({time.time() - t0:.1f}s)")

    t0 = time.time()
    fitted, _ = fit_mod.fit(sgp, num_restarts=1, maxiter=50,
                            generator=generator(0, new["device"]))
    print(f"fitted bound: {float(fitted.log_marginal_likelihood()):.1f}  "
          f"({time.time() - t0:.1f}s)")

    svgp = SVGP.create(X, Y, kernel=k, num_inducing=m, noise_var=0.05, **new)
    t0 = time.time()
    svgp_fitted, losses = fit_svgp(svgp, X, Y, num_steps=svgp_steps, batch_size=2048,
                                   learning_rate=1e-2)
    print(f"SVGP: -ELBO {losses[0]:.1f} -> {losses[-1]:.1f} over {svgp_steps} steps "
          f"({time.time() - t0:.1f}s)")

    Xs = rng.uniform(-3, 3, size=(5, 2))
    mu, _ = fitted.predict(torch.as_tensor(Xs, **new))
    truth = np.sin(Xs[:, :1] * 2) * np.cos(Xs[:, 1:])
    print("sparse predictions:", to_numpy(mu).flatten().round(3))
    print("truth             :", truth.flatten().round(3))
    return fitted, svgp_fitted


if __name__ == "__main__":
    main()

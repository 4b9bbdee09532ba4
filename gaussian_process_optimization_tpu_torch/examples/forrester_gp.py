"""Exact GP regression on the Forrester function: fit, predict, plot (twin of
``examples/forrester_gp.py``; BASELINE config 1).

Run: python -m gaussian_process_optimization_tpu_torch.examples.forrester_gp
"""
import numpy as np

from .. import kernels as kern
from ..bo import objectives
from ..kernels.base import placement
from ..models import fit as fit_mod
from ..models.gp import GPRegression
from ._util import generator


def main(n=25, out="forrester_gp.png", seed=0, plot=True, device=None, dtype=None):
    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(n, 1))
    Y = np.asarray(objectives.forrester(X)) + 0.2 * rng.standard_normal((n, 1))

    model = GPRegression.create(X, Y, kernel=kern.RBF.create(1, **new), noise_var=0.5,
                                normalizer=True, **new)
    print(f"initial LML: {float(model.log_marginal_likelihood()):.3f}")
    model, _ = fit_mod.fit(model, num_restarts=5, maxiter=500,
                           generator=generator(seed, new["device"]))
    print(f"fitted  LML: {float(model.log_marginal_likelihood()):.3f}")
    print(f"lengthscale: {float(model.kern.lengthscale):.4f}  "
          f"variance: {float(model.kern.variance):.4f}  "
          f"noise: {float(model.likelihood_variance):.5f}")
    if plot:
        model.plot(bounds=[(0, 1)], filename=out, n_samples=3, title="GP on Forrester")
        print(f"wrote {out}")
    return model


if __name__ == "__main__":
    main()

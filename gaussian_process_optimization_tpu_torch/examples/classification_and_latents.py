"""A feature tour (twin of ``examples/classification_and_latents.py``): EP
classification (dense and sparse), periodic state-space GPs, and MRD latent
discovery.

Run: python -m gaussian_process_optimization_tpu_torch.examples.classification_and_latents
"""
import numpy as np

from .. import kernels as kern
from ..kernels.base import placement
from ._util import to_numpy


def classification_demo(n=40, seed=0, plot=False, out=None, device=None, dtype=None):
    """Probit EP classification, dense against sparse (EPDTC)."""
    from ..models.classification import GPClassification, SparseGPClassification

    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-2, -0.3, n // 2), rng.uniform(0.3, 2, n // 2)])[:, None]
    y = (X[:, 0] > 0).astype(float)
    dense = GPClassification.create(X, y, kernel=kern.RBF.create(1, variance=3.0, **new),
                                    **new)
    sparse = SparseGPClassification.create(
        X, y, num_inducing=8, kernel=kern.RBF.create(1, variance=3.0, **new), **new)
    Xs = np.linspace(-2, 2, 101)[:, None]
    p_dense = to_numpy(dense.predict(Xs))
    p_sparse = to_numpy(sparse.predict(Xs))
    if plot and out:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(7, 4))
        plt.plot(Xs, p_dense, label="dense EP")
        plt.plot(Xs, p_sparse, "--", label="sparse EPDTC (m=8)")
        plt.scatter(X[:, 0], y, c="k", marker="x", label="labels")
        plt.legend()
        plt.savefig(out, bbox_inches="tight")
        plt.close()
    return p_dense, p_sparse


def periodic_state_space_demo(n=60, seed=0, device=None, dtype=None):
    """The linear-time periodic GP against its dense equivalent."""
    from ..models.gp import GPRegression
    from ..models.state_space import from_kernel

    new = placement(dtype, device)
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 6, n))[:, None]
    y = np.sin(2 * np.pi * t[:, 0] / 1.5) + 0.1 * rng.standard_normal(n)
    k = kern.StandardPeriodic.create(1, variance=1.0, period=1.5, lengthscale=1.0, **new)
    ss = from_kernel(k, t, y, noise_var=0.05, order=8, **new)
    dense = GPRegression.create(t, y[:, None], kernel=k, noise_var=0.05, **new)
    return float(ss.log_marginal_likelihood()), float(dense.log_marginal_likelihood())


def mrd_demo(n=40, seed=0, device=None, dtype=None):
    """Two-view MRD: shared and private latent structure through ARD relevance."""
    from ..models.mrd import MRD, fit_mrd

    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n)
    shared, p1, p2 = np.sin(t), np.cos(3 * t), np.sin(5 * t)
    W1 = rng.standard_normal((2, 5))
    W2 = rng.standard_normal((2, 5))
    Y1 = np.stack([shared, p1], 1) @ W1 + 0.05 * rng.standard_normal((n, 5))
    Y2 = np.stack([shared, p2], 1) @ W2 + 0.05 * rng.standard_normal((n, 5))
    m = MRD.create([Y1, Y2], input_dim=4, num_inducing=10, seed=seed, device=device,
                   dtype=dtype)
    fitted, _ = fit_mrd(m, maxiter=120)
    return to_numpy(fitted.relevance())


def main(plot=False, out=None, device=None, dtype=None):
    p_dense, p_sparse = classification_demo(plot=plot, out=out, device=device, dtype=dtype)
    print(f"classification: p(y=1|x=-1.5) dense={float(np.ravel(p_dense)[12]):.3f} "
          f"sparse={float(np.ravel(p_sparse)[12]):.3f}")
    lml_ss, lml_dense = periodic_state_space_demo(device=device, dtype=dtype)
    print(f"periodic state-space LML {lml_ss:.3f} vs dense {lml_dense:.3f} "
          f"(diff {abs(lml_ss - lml_dense):.2e})")
    rel = mrd_demo(device=device, dtype=dtype)
    print("MRD relevance (views x latents):")
    print(np.round(rel / rel.max(axis=1, keepdims=True), 3))
    return lml_ss, lml_dense


if __name__ == "__main__":
    main(plot=True, out="classification.png")

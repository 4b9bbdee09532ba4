"""Convergence and acquisition diagnostics plots (twin of
``gaussian_process_optimization_tpu/utils/plotting.py``; GPyOpt plotting/plots_bo.py:11
``plot_acquisition``, ``plot_convergence``). Host numpy over the model's
predictions, drawn with matplotlib's 'Agg' backend: files are written, no
display is needed. Matplotlib is imported when a plot is drawn, never at import.
"""
from __future__ import annotations

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_acquisition(bounds, input_dim, model, Xdata, Ydata, acquisition_function,
                     suggested_sample, filename=None, label_x=None, label_y=None):
    """1-D / 2-D model and acquisition plots (plots_bo.py:11-115); ``model``
    gives numpy (mean, std) from ``predict``, ``acquisition_function`` numpy
    minimize-convention values."""
    plt = _plt()
    if input_dim == 1:
        x_grid = np.linspace(bounds[0][0], bounds[0][1], 200)[:, None]
        m, s = model.predict(x_grid)
        acq = -acquisition_function(x_grid)
        acq = (acq - acq.min()) / max(acq.max() - acq.min(), 1e-12)
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
        ax1.plot(x_grid, m, "k-", label="posterior mean")
        ax1.fill_between(x_grid[:, 0], (m - 1.96 * s)[:, 0], (m + 1.96 * s)[:, 0],
                         alpha=0.25, label="95% CI")
        Ycol = Ydata[:, 0] if Ydata.ndim > 1 else np.asarray(Ydata).ravel()
        mask = np.isfinite(Ycol)
        ax1.plot(Xdata[mask, 0], Ycol[mask], "r.", markersize=10,
                 label="observations")
        ax1.axvline(float(np.atleast_2d(suggested_sample)[0, 0]), color="r", ls="--")
        ax1.legend(loc="best")
        ax1.set_ylabel(label_y or "f(x)")
        ax2.plot(x_grid, acq, "r-", label="acquisition (normalized)")
        ax2.axvline(float(np.atleast_2d(suggested_sample)[0, 0]), color="r", ls="--")
        ax2.set_xlabel(label_x or "x")
        ax2.legend(loc="best")
    elif input_dim == 2:
        n = 60
        X1, X2 = np.meshgrid(
            np.linspace(bounds[0][0], bounds[0][1], n),
            np.linspace(bounds[1][0], bounds[1][1], n),
        )
        grid = np.hstack([X1.reshape(-1, 1), X2.reshape(-1, 1)])
        m, s = model.predict(grid)
        acq = -acquisition_function(grid)
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.5))
        for ax, vals, title in zip(
            axes, [m[:, 0], s[:, 0], acq.flatten()],
            ["posterior mean", "posterior std", "acquisition"],
        ):
            c = ax.contourf(X1, X2, vals.reshape(n, n), 30)
            ax.plot(Xdata[:, 0], Xdata[:, 1], "r.", markersize=8)
            ax.plot(np.atleast_2d(suggested_sample)[:, 0],
                    np.atleast_2d(suggested_sample)[:, 1], "m*", markersize=12)
            ax.set_title(title)
            fig.colorbar(c, ax=ax)
    else:
        raise ValueError("plot_acquisition supports 1-D and 2-D inputs only")
    if filename is not None:
        plt.savefig(filename, bbox_inches="tight")
        plt.close("all")
    return True


def plot_gp(model, bounds=None, filename=None, resolution=200, n_samples=0,
            generator=None, title=None):
    """GP posterior plot: mean, 95% band and data (and posterior samples, drawn
    from ``generator``), the 2-D renderer of the injected ``m.plot()`` family
    (GPy plotting/gpy_plot, inject_plotting:41). 1-D and 2-D inputs."""
    from .plotting_library import _model_xy

    plt = _plt()
    X, Y = _model_xy(model)
    d = X.shape[1]
    if bounds is None:
        lo, hi = X.min(0), X.max(0)
        pad = 0.1 * (hi - lo + 1e-9)
        bounds = list(zip(lo - pad, hi + pad))
    if d == 1:
        xs = np.linspace(bounds[0][0], bounds[0][1], resolution)[:, None]
        from .plotting_library import _predict_np, _tensor

        # the heteroscedastic noise_at_test='mean' choice lives in one place
        mu, sd = _predict_np(model, xs)
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(xs[:, 0], mu, "b-", label="mean")
        ax.fill_between(xs[:, 0], mu - 1.96 * sd, mu + 1.96 * sd, alpha=0.25,
                        label="95% CI")
        if n_samples:
            with torch.no_grad():
                S = model.posterior_samples_f(_tensor(model, xs), n_samples,
                                              generator=generator)
            ax.plot(xs[:, 0], S.cpu().numpy(), lw=0.6, alpha=0.6)
        ax.plot(X[:, 0], Y[:, 0], "kx", markersize=8, label="data")
        ax.legend(loc="best")
    elif d == 2:
        from .plotting_library import _tensor

        n = 60
        g1 = np.linspace(bounds[0][0], bounds[0][1], n)
        g2 = np.linspace(bounds[1][0], bounds[1][1], n)
        G1, G2 = np.meshgrid(g1, g2)
        grid = np.stack([G1.ravel(), G2.ravel()], 1)
        with torch.no_grad():
            mu, var = model.predict(_tensor(model, grid))
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.5))
        for ax, v, t in [(ax1, mu.cpu().numpy()[:, 0], "posterior mean"),
                         (ax2, np.sqrt(var.cpu().numpy())[:, 0], "posterior std")]:
            c = ax.contourf(G1, G2, v.reshape(n, n), 30)
            ax.plot(X[:, 0], X[:, 1], "kx")
            ax.set_title(t)
            fig.colorbar(c, ax=ax)
    else:
        raise ValueError("plot_gp supports 1-D and 2-D inputs")
    if title:
        plt.suptitle(title)
    if filename is not None:
        plt.savefig(filename, bbox_inches="tight")
        plt.close("all")
    return True


def plot_convergence(Xdata, best_Y, filename=None):
    """Distance between consecutive x's and best-Y curve (plots_bo.py
    plot_convergence)."""
    plt = _plt()
    n = Xdata.shape[0]
    dist = np.sqrt(np.sum(np.square(Xdata[1:] - Xdata[:-1]), axis=1))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    ax1.plot(np.arange(1, n), dist, "-ro")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel(r"d(x[n], x[n-1])")
    ax1.set_title("Distance between consecutive x's")
    ax2.plot(np.arange(1, len(best_Y) + 1), best_Y, "-o")
    ax2.set_xlabel("iteration")
    ax2.set_ylabel("best y")
    ax2.set_title("Value of the best selected sample")
    if filename is not None:
        plt.savefig(filename, bbox_inches="tight")
        plt.close("all")
    return True

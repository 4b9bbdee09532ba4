"""Backend-switchable plotting abstraction and the gpy_plot family (twin of
``gaussian_process_optimization_tpu/utils/plotting_library.py``).

Rebuild of GPy's plotting layer (``GPy/GPy/plotting/__init__.py:8``
``change_plotting_library``, ``abstract_plotting_library.py``, the
``gpy_plot/`` generic plots and ``inject_plotting`` (:41) that attaches
``m.plot*`` methods onto models):

- ``change_plotting_library(name)`` / ``plotting_library()`` — global backend
  switch. Backends: 'matplotlib' (default, Agg), 'none' (all plot calls become
  no-ops returning None, as GPy supports), 'plotly' (registered; raises a clear
  ImportError if the plotly package is absent — it is not shipped in this
  environment and installs are disallowed, so the backend is gated not vendored).
- the generic plot family, written against the small backend-primitive interface
  (``AbstractPlottingLibrary``): ``plot_data``, ``plot_mean``,
  ``plot_confidence``, ``plot_samples``, ``plot_density``, and the composite
  ``plot`` — injected as methods on the GP model classes by
  ``inject_plotting()`` (called at models package import, like GPy's).

All model math stays in the model (on its device); backends only receive
numpy arrays. Matplotlib and plotly are imported inside the functions that
draw, never at import: a machine without them imports this module and runs
the 'none' backend.
"""
from __future__ import annotations

import numpy as np
import torch

from .tree import named_leaves

# --------------------------------------------------------------------- backends


class AbstractPlottingLibrary:
    """Primitive interface the generic plots are written against
    (GPy plotting/abstract_plotting_library.py)."""

    name = "abstract"

    def figure(self, rows=1, cols=1, figsize=None):
        raise NotImplementedError

    def plot(self, ax, x, y, color=None, label=None, linewidth=None, marker=None,
             alpha=None):
        raise NotImplementedError

    def scatter(self, ax, x, y, color=None, label=None, marker="x", s=None):
        raise NotImplementedError

    def fill_between(self, ax, x, lower, upper, color=None, alpha=0.3, label=None):
        raise NotImplementedError

    def contour(self, ax, X1, X2, Z, levels=30):
        raise NotImplementedError

    def bar(self, ax, x, height, bottom=None, color=None, label=None):
        raise NotImplementedError

    def errorbar(self, ax, x, y, yerr, color=None, label=None):
        raise NotImplementedError

    def imshow(self, ax, Z, extent=None, origin="lower"):
        raise NotImplementedError

    def text(self, ax, x, y, s, color=None):
        raise NotImplementedError

    def legend(self, ax):
        raise NotImplementedError

    def set_labels(self, ax, xlabel=None, ylabel=None, title=None):
        raise NotImplementedError

    def save(self, fig, filename):
        raise NotImplementedError


class MatplotlibBackend(AbstractPlottingLibrary):
    """(GPy plotting/matplot_dep/)."""

    name = "matplotlib"

    def _plt(self):
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt

    def figure(self, rows=1, cols=1, figsize=None):
        plt = self._plt()
        fig, axes = plt.subplots(rows, cols, figsize=figsize or (6 * cols, 4.5 * rows))
        return fig, np.atleast_1d(axes)

    def plot(self, ax, x, y, color=None, label=None, linewidth=None, marker=None,
             alpha=None):
        ax.plot(x, y, color=color, label=label, linewidth=linewidth, marker=marker,
                alpha=alpha)

    def scatter(self, ax, x, y, color=None, label=None, marker="x", s=None):
        ax.scatter(x, y, color=color or "k", label=label, marker=marker, s=s)

    def fill_between(self, ax, x, lower, upper, color=None, alpha=0.3, label=None):
        ax.fill_between(x, lower, upper, color=color, alpha=alpha, label=label)

    def contour(self, ax, X1, X2, Z, levels=30):
        c = ax.contourf(X1, X2, Z, levels)
        ax.figure.colorbar(c, ax=ax)

    def bar(self, ax, x, height, bottom=None, color=None, label=None):
        ax.bar(x, height, bottom=bottom, color=color, label=label)

    def errorbar(self, ax, x, y, yerr, color=None, label=None):
        ax.errorbar(np.asarray(x).ravel(), np.asarray(y).ravel(), yerr=yerr,
                    fmt="none", ecolor=color or "k", label=label)

    def imshow(self, ax, Z, extent=None, origin="lower"):
        im = ax.imshow(Z, extent=extent, origin=origin, aspect="auto",
                       interpolation="bilinear", cmap="gray")
        ax.figure.colorbar(im, ax=ax)

    def text(self, ax, x, y, s, color=None):
        ax.text(x, y, s, color=color or "tab:red", ha="center", va="center",
                fontsize=7)

    def legend(self, ax):
        ax.legend(loc="best")

    def set_labels(self, ax, xlabel=None, ylabel=None, title=None):
        if xlabel:
            ax.set_xlabel(xlabel)
        if ylabel:
            ax.set_ylabel(ylabel)
        if title:
            ax.set_title(title)

    def save(self, fig, filename):
        fig.savefig(filename, bbox_inches="tight")
        import matplotlib.pyplot as plt

        plt.close(fig)


class NoneBackend(AbstractPlottingLibrary):
    """Disables plotting (GPy supports library 'none'): every call is a no-op."""

    name = "none"

    def figure(self, rows=1, cols=1, figsize=None):
        return None, [None] * (rows * cols)

    def plot(self, *a, **k):
        return None

    def scatter(self, *a, **k):
        return None

    def fill_between(self, *a, **k):
        return None

    def contour(self, *a, **k):
        return None

    def bar(self, *a, **k):
        return None

    def errorbar(self, *a, **k):
        return None

    def imshow(self, *a, **k):
        return None

    def text(self, *a, **k):
        return None

    def legend(self, *a, **k):
        return None

    def set_labels(self, *a, **k):
        return None

    def save(self, *a, **k):
        return None


class PlotlyBackend(AbstractPlottingLibrary):
    """Gated plotly backend (GPy plotting/plotly_dep/): requires the plotly
    package, which is not bundled here — selecting it without plotly installed
    raises ImportError at switch time, not at plot time."""

    name = "plotly"

    def __init__(self):
        try:
            import plotly  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "the 'plotly' plotting backend requires the plotly package, "
                "which is not installed in this environment; use "
                "change_plotting_library('matplotlib') or 'none'"
            ) from e
        import plotly.graph_objects as go

        self._go = go

    def figure(self, rows=1, cols=1, figsize=None):
        from plotly.subplots import make_subplots

        fig = make_subplots(rows=rows, cols=cols)
        axes = [(fig, r + 1, c + 1) for r in range(rows) for c in range(cols)]
        return fig, axes

    def plot(self, ax, x, y, color=None, label=None, linewidth=None, marker=None,
             alpha=None):
        fig, r, c = ax
        fig.add_trace(
            self._go.Scatter(x=np.asarray(x).ravel(), y=np.asarray(y).ravel(),
                             mode="lines", name=label,
                             line=dict(color=color, width=linewidth),
                             opacity=alpha if alpha is not None else 1.0),
            row=r, col=c,
        )

    def scatter(self, ax, x, y, color=None, label=None, marker="x", s=None):
        fig, r, c = ax
        fig.add_trace(
            self._go.Scatter(x=np.asarray(x).ravel(), y=np.asarray(y).ravel(),
                             mode="markers", name=label,
                             marker=dict(color=color, size=s or 8)),
            row=r, col=c,
        )

    def fill_between(self, ax, x, lower, upper, color=None, alpha=0.3, label=None):
        fig, r, c = ax
        x = np.asarray(x).ravel()
        fig.add_trace(
            self._go.Scatter(
                x=np.concatenate([x, x[::-1]]),
                y=np.concatenate([np.asarray(upper).ravel(),
                                  np.asarray(lower).ravel()[::-1]]),
                fill="toself", name=label, opacity=alpha, mode="none",
            ),
            row=r, col=c,
        )

    def contour(self, ax, X1, X2, Z, levels=30):
        fig, r, c = ax
        fig.add_trace(
            self._go.Contour(x=X1[0], y=X2[:, 0], z=Z, ncontours=levels),
            row=r, col=c,
        )

    def legend(self, ax):
        return None  # plotly shows legends by default

    def set_labels(self, ax, xlabel=None, ylabel=None, title=None):
        fig, r, c = ax
        fig.update_xaxes(title_text=xlabel, row=r, col=c)
        fig.update_yaxes(title_text=ylabel, row=r, col=c)
        if title:
            fig.update_layout(title=title)

    def save(self, fig, filename):
        fig.write_html(str(filename) + (".html" if not str(filename).endswith(".html") else ""))


_BACKENDS = {
    "matplotlib": MatplotlibBackend,
    "none": NoneBackend,
    "plotly": PlotlyBackend,
}
_current: AbstractPlottingLibrary = MatplotlibBackend()


def change_plotting_library(name: str):
    """(GPy plotting/__init__.py:8)"""
    global _current
    if name not in _BACKENDS:
        raise ValueError(f"unknown plotting library {name!r}; options: {sorted(_BACKENDS)}")
    _current = _BACKENDS[name]()
    return _current


def plotting_library() -> AbstractPlottingLibrary:
    return _current


# ------------------------------------------------------------- gpy_plot family


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tensor(model, a):
    """``a`` as a tensor on the model's device, in its dtype."""
    ref = next(t for t in (getattr(model, f, None) for f in ("X", "Z", "q_mu"))
               if isinstance(t, torch.Tensor))
    return torch.as_tensor(np.asarray(a, dtype=float), dtype=ref.dtype, device=ref.device)


def _model_xy(model):
    X = _np(model.X)
    Y = _np(model.Y)
    if getattr(model, "mask", None) is not None:
        keep = _np(model.mask) > 0
        X, Y = X[keep], Y[keep]
    return X, Y


def fixed_inputs(model, non_fixed_dims, fix_routine="median", as_list=True,
                 X_all=False):
    """Values at which to hold the non-plotted input dims (GPy
    plotting/matplot_dep/util.py fixed_inputs; behavior pinned by
    GPy/testing/util_tests.py:53-100). Returns [(dim, value)] for every input
    dim NOT in ``non_fixed_dims``; ``fix_routine`` in {'median','mean','zero'}.
    Uncertain-input models (BayesianGPLVM) use the posterior means q_mu, like
    the reference uses X.mean for NormalPosterior inputs."""
    del X_all  # reference flag for trainset-vs-all rows; we always use model.X
    X = _np(model.q_mu) if hasattr(model, "q_mu") else _model_xy(model)[0]
    routines = {
        "median": lambda col: float(np.median(col)),
        "mean": lambda col: float(np.mean(col)),
        "zero": lambda col: 0.0,
    }
    if fix_routine not in routines:
        raise ValueError(f"fix_routine must be one of {sorted(routines)}")
    fn = routines[fix_routine]
    keep = {int(d) for d in non_fixed_dims}
    out = [(d, fn(X[:, d])) for d in range(X.shape[1]) if d not in keep]
    return out if as_list else dict(out)


def _free_dims(model, visible_dims, fixed):
    D = model.X.shape[1]
    fixed_dims = {int(i) for i, _ in (fixed or [])}
    if visible_dims is not None:
        free = [int(d) for d in np.atleast_1d(visible_dims)]
    else:
        free = [d for d in range(D) if d not in fixed_dims]
    return free, D


def _grid_1d(model, resolution=200, bounds=None, visible_dims=None,
             fixed_inputs=None):
    """(R, D) prediction grid with exactly ONE free dim varying and the rest
    held at their fixed_inputs values (gpy_plot/plot_util.py:103-126
    helper_for_plot_data; unfixed non-visible dims sit at 0 like the
    reference's np.zeros Xgrid). Returns (Xgrid, free_dim)."""
    free, D = _free_dims(model, visible_dims, fixed_inputs)
    if len(free) != 1:
        raise ValueError(
            f"1-D plot needs exactly one free dim; got {free} from "
            f"visible_dims={visible_dims} fixed_inputs={fixed_inputs} "
            "(use utils.plotting_library.fixed_inputs(model, [dim]) to pin "
            "the others)")
    d0 = free[0]
    X, _ = _model_xy(model)
    if bounds is not None:
        # per-dim bounds list: index by the FREE dim (a single (lo, hi) pair
        # is also accepted); bounds[0] regardless of d0 misapplied dim-0's
        # range whenever visible_dims selected another dim (review round 4)
        if len(bounds) > d0 and np.ndim(bounds[0]) > 0:
            lo, hi = bounds[d0]
        else:
            lo, hi = bounds if np.ndim(bounds[0]) == 0 else bounds[0]
    else:
        lo, hi = X[:, d0].min(), X[:, d0].max()
        pad = 0.1 * (hi - lo + 1e-9)
        lo, hi = lo - pad, hi + pad
    grid = np.zeros((resolution, D))
    grid[:, d0] = np.linspace(lo, hi, resolution)
    for i, v in fixed_inputs or []:
        grid[:, int(i)] = v
    return grid, d0


def _predict_np(model, xs):
    """(mean, std) at the grid ``xs`` as numpy; a heteroscedastic model adds
    the mean of its training noises."""
    kw = {"noise_at_test": "mean"} if getattr(model, "heteroscedastic", False) else {}
    with torch.no_grad():
        mu, var = model.predict(_tensor(model, xs), **kw)
    return _np(mu)[:, 0], np.sqrt(_np(var))[:, 0]


def plot_data(model, ax=None, filename=None, visible_dims=None):
    """(gpy_plot/data_plots.py)"""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    X, Y = _model_xy(model)
    d0 = int(np.atleast_1d(visible_dims)[0]) if visible_dims is not None else 0
    pl.scatter(axes[0], X[:, d0], Y[:, 0], label="data")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_mean(model, ax=None, resolution=200, filename=None, bounds=None,
              precomputed=None, visible_dims=None, fixed_inputs=None):
    """(gpy_plot/gp_plots.py plot_mean). `precomputed=(x_axis, mu, sd)` lets
    the composite plot() share one posterior inference across layers."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    if precomputed is None:
        xs, d0 = _grid_1d(model, resolution, bounds, visible_dims, fixed_inputs)
        mu, _ = _predict_np(model, xs)
        x_axis = xs[:, d0]
    else:
        x_axis, mu, _ = precomputed
    pl.plot(axes[0], x_axis, mu, color="b", label="mean")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_confidence(model, ax=None, resolution=200, lower=2.5, upper=97.5,
                    filename=None, bounds=None, precomputed=None,
                    visible_dims=None, fixed_inputs=None):
    """(gpy_plot/gp_plots.py plot_confidence): central credible band."""
    from scipy.stats import norm

    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    if precomputed is None:
        xs, d0 = _grid_1d(model, resolution, bounds, visible_dims, fixed_inputs)
        mu, sd = _predict_np(model, xs)
        x_axis = xs[:, d0]
    else:
        x_axis, mu, sd = precomputed
    zl, zu = norm.ppf(lower / 100.0), norm.ppf(upper / 100.0)
    pl.fill_between(axes[0], x_axis, mu + zl * sd, mu + zu * sd, alpha=0.3,
                    label=f"{upper - lower:.0f}% CI")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_samples(model, ax=None, resolution=200, samples=3, generator=None,
                 filename=None, bounds=None, visible_dims=None,
                 fixed_inputs=None):
    """(gpy_plot/gp_plots.py plot_samples): posterior function draws, from
    ``generator`` (one seeded with 0 on the model's device by default)."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    xs, d0 = _grid_1d(model, resolution, bounds, visible_dims, fixed_inputs)
    Xt = _tensor(model, xs)
    if generator is None:
        generator = torch.Generator(device=Xt.device).manual_seed(0)
    with torch.no_grad():
        S = _np(model.posterior_samples_f(Xt, samples, generator=generator))
    for i in range(S.shape[1]):
        pl.plot(axes[0], xs[:, d0], S[:, i], linewidth=0.8, alpha=0.7)
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_density(model, ax=None, resolution=200, levels=32, filename=None,
                 visible_dims=None, fixed_inputs=None):
    """(gpy_plot/gp_plots.py plot_density): predictive density as stacked
    translucent quantile bands."""
    from scipy.stats import norm

    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    xs, d0 = _grid_1d(model, resolution, None, visible_dims, fixed_inputs)
    mu, sd = _predict_np(model, xs)
    qs = np.linspace(0.02, 0.98, levels)
    for lo_q, hi_q in zip(qs[:-1], qs[1:]):
        zl, zu = norm.ppf(lo_q), norm.ppf(hi_q)
        pl.fill_between(axes[0], xs[:, d0], mu + zl * sd, mu + zu * sd,
                        alpha=1.5 / levels, color="b")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot(model, ax=None, resolution=200, samples=0, filename=None, title=None,
         bounds=None, n_samples=None, generator=None, visible_dims=None,
         fixed_inputs=None):
    """Composite m.plot(): data + mean + confidence (+ samples)
    (gpy_plot/gp_plots.py plot). `bounds`/`n_samples` kept for compatibility
    with the round-1 plot_gp signature. `visible_dims`/`fixed_inputs` slice
    higher-D models down to a 1-D section like the reference's
    helper_for_plot_data (gpy_plot/plot_util.py:103-126)."""
    if n_samples:
        samples = n_samples
    X, _ = _model_xy(model)
    free, _D = _free_dims(model, visible_dims, fixed_inputs)
    if len(free) != 1:
        # 2-D (contour) plots keep the round-1 plot_gp renderer
        from .plotting import plot_gp

        return plot_gp(model, bounds=bounds, filename=filename, resolution=resolution,
                       n_samples=samples, generator=generator, title=title)
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    a = axes[0]
    # one posterior inference for both layers (each used to re-run predict,
    # i.e. a fresh Cholesky per layer for uncached models)
    xs, d0 = _grid_1d(model, resolution, bounds, visible_dims, fixed_inputs)
    mu, sd = _predict_np(model, xs)
    plot_confidence(model, ax=a, precomputed=(xs[:, d0], mu, sd))
    plot_mean(model, ax=a, precomputed=(xs[:, d0], mu, sd))
    if samples:
        plot_samples(model, ax=a, resolution=resolution, samples=samples,
                     bounds=bounds, generator=generator, visible_dims=visible_dims,
                     fixed_inputs=fixed_inputs)
    plot_data(model, ax=a, visible_dims=(d0,))
    pl.legend(a)
    pl.set_labels(a, xlabel="x", ylabel="f(x)", title=title)
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


# ------------------------------------------------------------- latent plots
def _latent_XQ(model):
    """(latent means (N, Q), ARD relevances (Q,)): GPLVM stores latents in X,
    BayesianGPLVM in q_mu; relevance = kern.input_sensitivity() (GPy
    get_most_significant_input_dimensions, kern/src/kern.py:680)."""
    X = _np(model.q_mu) if hasattr(model, "q_mu") else _np(model.X)
    try:
        rel = _np(model.kern.input_sensitivity()).reshape(-1)
    except Exception:
        rel = np.zeros(X.shape[1])
    if rel.shape[0] < X.shape[1]:
        rel = np.concatenate([rel, np.zeros(X.shape[1] - rel.shape[0])])
    rel = rel[: X.shape[1]]
    if not np.any(rel != 0):
        rel = np.ones(X.shape[1])
    return X, rel


def _significant_dims(model, which_indices=None):
    """Two most ARD-relevant latent dims (latent_plots.py:92-96). The latent
    plot family needs TWO distinct dims (the reference's
    get_most_significant_input_dimensions requires the same); a 1-D latent
    space raises rather than silently rendering X[:,0] against itself."""
    if which_indices is not None:
        d0, d1 = tuple(which_indices)
        if d0 == d1:
            raise ValueError("which_indices must name two distinct latent dims")
        return d0, d1
    _, rel = _latent_XQ(model)
    if rel.shape[0] < 2:
        raise ValueError(
            "latent plots need >= 2 latent dimensions; this model has "
            f"{rel.shape[0]} (use plot/plot_mean for 1-D latent spaces)")
    order = np.argsort(rel)[::-1]
    return int(order[0]), int(order[1])


def plot_latent_scatter(model, labels=None, which_indices=None, ax=None,
                        filename=None):
    """Latent positions scattered over the two most-relevant dims, colored by
    label (gpy_plot/latent_plots.py plot_latent_scatter:80)."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    X, _ = _latent_XQ(model)
    d0, d1 = _significant_dims(model, which_indices)
    if labels is None:
        pl.scatter(axes[0], X[:, d0], X[:, d1], label="latents")
    else:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            keep = labels == lab
            pl.scatter(axes[0], X[keep, d0], X[keep, d1], label=str(lab))
    pl.set_labels(axes[0], xlabel=f"latent dim {d0}", ylabel=f"latent dim {d1}")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_latent_inducing(model, which_indices=None, ax=None, filename=None):
    """Inducing inputs in latent space (latent_plots.py plot_latent_inducing
    :111) — BayesianGPLVM/sparse models with a Z."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    Z = _np(model.Z)
    d0, d1 = _significant_dims(model, which_indices)
    pl.scatter(axes[0], Z[:, d0], Z[:, d1], marker="^", label="inducing")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def _latent_grid(model, which_indices, resolution):
    X, _ = _latent_XQ(model)
    d0, d1 = which_indices
    pads = 0.1 * (X.max(0) - X.min(0) + 1e-9)
    g0 = np.linspace(X[:, d0].min() - pads[d0], X[:, d0].max() + pads[d0],
                     resolution)
    g1 = np.linspace(X[:, d1].min() - pads[d1], X[:, d1].max() + pads[d1],
                     resolution)
    G0, G1 = np.meshgrid(g0, g1)
    Xg = np.tile(X.mean(0), (resolution * resolution, 1))
    Xg[:, d0] = G0.ravel()
    Xg[:, d1] = G1.ravel()
    return G0, G1, Xg


def _latent_jacobian(model, Xg):
    """(R, P, Q) Jacobians of the predictive mean at the latent grid rows
    ``Xg``, the posterior solved once. Each row's mean depends on that row
    alone, so one forward-mode pass per latent dimension gives every row's
    column (through the K kernel's forward rule on a card)."""
    if hasattr(model, "posterior_u"):
        post = model.posterior_u()

        def mean(X):
            return model.predict(X, posterior=post)[0]
    else:
        post = model.inference()

        def mean(X):
            return model._raw_predict(X, posterior=post)[0]

    X = _tensor(model, Xg)
    cols = []
    with torch.no_grad():
        for q in range(X.shape[1]):
            T = torch.zeros_like(X)
            T[:, q] = 1.0
            cols.append(torch.func.jvp(mean, (X,), (T,))[1])
    return torch.stack(cols, dim=-1)


def plot_magnification(model, which_indices=None, resolution=40, ax=None,
                       filename=None, mean=True, covariance=True):
    """Magnification-factor map sqrt(det(G)) of the latent->data mapping over
    a latent grid (gpy_plot/latent_plots.py plot_magnification :145,
    util/linalg magnification). With the default mean=True, covariance=True
    and a model exposing ``predict_magnification`` (exact GPs), G is the full
    expected Wishart metric J_mu^T J_mu + P Cov[J] (GPy gp.py:521/556);
    otherwise G falls back to the mean-Jacobian metric J^T J with J forward
    mode through predict, exact for every model and kernel.
    mean=False drops the mean-Jacobian term (covariance-only map), mirroring
    the reference's switch."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    d0, d1 = _significant_dims(model, which_indices)
    G0, G1, Xg = _latent_grid(model, (d0, d1), resolution)

    if hasattr(model, "predict_magnification"):
        with torch.no_grad():
            M = _np(model.predict_magnification(
                _tensor(model, Xg), mean=mean, covariance=covariance,
                dimensions=(d0, d1))).reshape(G0.shape)
    else:
        if not mean:
            raise NotImplementedError(
                "mean=False needs the model's predict_magnification "
                "(covariance-corrected Wishart metric); this model only "
                "supports the mean-Jacobian map")
        J = _latent_jacobian(model, Xg)[:, :, [d0, d1]]  # (R, P, 2)
        JtJ = J.transpose(-1, -2) @ J
        M = _np(torch.sqrt(torch.clamp(torch.linalg.det(JtJ), min=0.0))).reshape(G0.shape)
    pl.contour(axes[0], G0, G1, M)
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig, M


def plot_latent(model, labels=None, which_indices=None, resolution=40, ax=None,
                filename=None):
    """Composite latent plot: magnification background + latent scatter
    (+ inducing markers when the model has Z) — gpy_plot/latent_plots.py
    plot_latent:194."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    a = axes[0]
    plot_magnification(model, which_indices=which_indices,
                       resolution=resolution, ax=a)
    plot_latent_scatter(model, labels=labels, which_indices=which_indices, ax=a)
    if getattr(model, "Z", None) is not None:
        plot_latent_inducing(model, which_indices=which_indices, ax=a)
    pl.legend(a)
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_steepest_gradient_map(model, output_labels=None, which_indices=None,
                               resolution=15, ax=None, filename=None):
    """Heat map over the latent grid of the steepest output gradient: at each
    point, max over outputs p of ||d mu_p / dX||, annotated with the argmax
    output's label (gpy_plot/latent_plots.py plot_steepest_gradient_map:305,
    _plot_steepest_gradient_map:282). The Jacobian is forward mode through the
    predictive mean rather than hand-written predictive_gradients plumbing."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    d0, d1 = _significant_dims(model, which_indices)
    G0, G1, Xg = _latent_grid(model, (d0, d1), resolution)
    J = _latent_jacobian(model, Xg)  # (R*R, P, Q)
    Gn = _np(torch.sqrt(torch.sum(J * J, dim=-1)))  # (R*R, P)
    steepest = Gn.max(axis=1).reshape(G0.shape)
    argmax = Gn.argmax(axis=1).reshape(G0.shape)
    pl.imshow(axes[0], steepest,
              extent=(G0.min(), G0.max(), G1.min(), G1.max()))
    if output_labels is None:
        output_labels = [str(i) for i in range(Gn.shape[1])]
    if resolution <= 20:  # annotation unreadable (and slow) beyond this
        for i in range(resolution):
            for j in range(resolution):
                pl.text(axes[0], G0[i, j], G1[i, j],
                        str(output_labels[argmax[i, j]]))
    pl.set_labels(axes[0], xlabel=f"latent dim {d0}", ylabel=f"latent dim {d1}")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig, steepest, argmax


# -------------------------------------------------- data/kernel plot tail
def plot_f(model, ax=None, resolution=200, filename=None, bounds=None,
           visible_dims=None, fixed_inputs=None):
    """Latent-function plot: mean and 95% band of p(f*) WITHOUT likelihood
    noise (gpy_plot/gp_plots.py plot_f:357)."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    xs, d0 = _grid_1d(model, resolution, bounds, visible_dims, fixed_inputs)
    with torch.no_grad():
        if hasattr(model, "predict_noiseless"):
            mu, var = model.predict_noiseless(_tensor(model, xs))
        else:
            mu, var = model.predict(_tensor(model, xs), include_likelihood=False)
    mu = _np(mu)[:, 0]
    sd = np.sqrt(_np(var))[:, 0]
    pl.plot(axes[0], xs[:, d0], mu, label="f mean")
    pl.fill_between(axes[0], xs[:, d0], mu - 1.96 * sd, mu + 1.96 * sd,
                    label="f 95%")
    X, Y = _model_xy(model)
    pl.scatter(axes[0], X[:, d0], Y[:, 0], label="data")
    pl.legend(axes[0])
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_errorbars_trainset(model, ax=None, filename=None):
    """Likelihood-inclusive predictive errorbars AT the training inputs
    (gpy_plot/data_plots.py plot_errorbars_trainset:199; the reference's
    2.5/97.5 percentiles == +/-1.96 sigma for a Gaussian predictive).
    Heteroscedastic models keep each training row's own noise."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    X, Y = _model_xy(model)
    kw = {}
    if getattr(model, "heteroscedastic", False):
        vrow = _np(model.likelihood_variance)
        if getattr(model, "mask", None) is not None:
            vrow = vrow[_np(model.mask) > 0]
        kw = {"noise_at_test": _tensor(model, vrow)}
    with torch.no_grad():
        mu, var = model.predict(_tensor(model, X), **kw)
    mu = _np(mu)[:, 0]
    sd = np.sqrt(_np(var))[:, 0]
    pl.errorbar(axes[0], X[:, 0], mu, 1.96 * sd, label="95% predictive")
    pl.scatter(axes[0], X[:, 0], Y[:, 0], label="data")
    pl.legend(axes[0])
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_inducing(model, visible_dims=None, ax=None, filename=None):
    """Inducing inputs of a sparse model in DATA space (gpy_plot/data_plots.py
    plot_inducing:161): 1-D draws a rug under the data, 2-D a scatter."""
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    Z = _np(model.Z)
    dims = (tuple(visible_dims) if visible_dims is not None
            else tuple(range(min(2, Z.shape[1]))))
    if len(dims) == 1:
        _, Y = _model_xy(model)
        y0 = float(Y.min()) - 0.1 * (float(Y.max()) - float(Y.min()) + 1e-9)
        pl.scatter(axes[0], Z[:, dims[0]], np.full(Z.shape[0], y0),
                   marker="^", label="inducing")
    else:
        pl.scatter(axes[0], Z[:, dims[0]], Z[:, dims[1]], marker="^",
                   label="inducing")
    pl.legend(axes[0])
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def plot_ARD(kernel, ax=None, filename=None, filtering=None):
    """Stacked per-part bars of kernel.input_sensitivity() per input dimension
    (gpy_plot/kernel_plots.py plot_ARD:36). ``filtering``: list of kernel class
    names to include (the reference filters by part name)."""
    from ..kernels.base import Add, Prod

    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    parts = list(kernel.parts) if isinstance(kernel, (Add, Prod)) else [kernel]
    if filtering is not None:
        parts = [p for p in parts if type(p).__name__ in filtering]
    sens = [_np(p._scatter_sensitivity()) for p in parts]
    width = max([1] + [s.shape[0] for s in sens])
    x = np.arange(width)
    bottom = np.zeros(width)
    for p, s in zip(parts, sens):
        h = np.zeros(width)
        h[: s.shape[0]] = s
        pl.bar(axes[0], x, h, bottom=bottom.copy(), label=type(p).__name__)
        bottom = bottom + h
    pl.set_labels(axes[0], xlabel="input dimension", ylabel="ard contribution")
    pl.legend(axes[0])
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig, bottom


def plot_covariance(kernel, x=None, plot_limits=(-3.0, 3.0), resolution=None,
                    ax=None, filename=None):
    """k(X, x) over a grid (gpy_plot/kernel_plots.py plot_covariance:86):
    1-D line for input_dim 1, filled contour for input_dim 2. Default second
    argument follows the reference: zeros for stationary kernels, ones
    otherwise (kernel_plots.py:104-107)."""
    from ..kernels.stationary import Stationary

    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    D = kernel.input_dim
    if x is None:
        x = np.ones((1, D)) * (0.0 if isinstance(kernel, Stationary) else 1.0)
    else:
        x = np.broadcast_to(np.atleast_2d(np.asarray(x, dtype=float)), (1, D))
    lo, hi = plot_limits
    ref = named_leaves(kernel)[0][1]

    def k_at(A):
        with torch.no_grad():
            return _np(kernel.K(*(torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
                                  for a in (A, x))))

    if D == 1:
        res = resolution or 200
        xs = np.linspace(lo, hi, res)[:, None]
        K = k_at(xs)[:, 0]
        pl.plot(axes[0], xs[:, 0], K, label=f"k(X, {x.ravel().tolist()})")
        pl.set_labels(axes[0], xlabel="X", ylabel="k(X, x)")
        pl.legend(axes[0])
    elif D == 2:
        res = resolution or 40
        g = np.linspace(lo, hi, res)
        G0, G1 = np.meshgrid(g, g)
        Xg = np.stack([G0.ravel(), G1.ravel()], axis=1)
        K = k_at(Xg).reshape(G0.shape)
        pl.contour(axes[0], G0, G1, K)
        pl.set_labels(axes[0], xlabel="X[:,0]", ylabel="X[:,1]")
    else:
        raise ValueError(
            "plot_covariance supports input_dim <= 2; use active_dims slicing")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig, K


def plot_optimizer(trace, ax=None, filename=None):
    """Objective-vs-iteration trace plot (gpy_plot/inference_plots.py
    plot_optimizer:10). Accepts an ``LBFGSResult`` from
    ``ops.lbfgs.minimize(..., trace=True)`` (or a ``Fitter``'s), any object
    with a ``.trace`` attribute, or a plain array; trailing NaNs (unreached
    iterations) are dropped. A ``(B, maxiter + 1)`` trace draws one line per
    lane."""
    t = getattr(trace, "trace", trace)
    if t is None:
        print("No trace present so I can't plot it. Pass trace=True to "
              "ops.lbfgs.minimize (or an array of objective values).")
        return None
    t = _np(t)
    lanes = t.reshape(-1, t.shape[-1]) if t.ndim > 1 else t.ravel()[None]
    pl = plotting_library()
    fig, axes = pl.figure() if ax is None else (None, [ax])
    for i, row in enumerate(lanes):
        # strip only TRAILING NaNs (unreached-iteration padding); interior NaNs
        # are real diverged steps and must stay on the iteration axis
        finite = np.where(~np.isnan(row))[0]
        row = row[: finite[-1] + 1] if finite.size else row[:0]
        pl.plot(axes[0], np.arange(row.shape[0]), row,
                label="objective" if lanes.shape[0] == 1 else f"lane {i}")
    pl.set_labels(axes[0], xlabel="Iteration", ylabel="f(x)")
    if filename and fig is not None:
        pl.save(fig, filename)
    return fig


def inject_plotting():
    """Attach the plot family as model methods (GPy plotting/__init__.py
    inject_plotting :41). Idempotent."""
    from ..kernels.base import Kernel
    from ..models.gp import GPRegression
    from ..models.gplvm import BayesianGPLVM
    from ..models.sparse import SparseGPRegression

    for cls in (GPRegression, SparseGPRegression):
        cls.plot = plot
        cls.plot_data = plot_data
        cls.plot_mean = plot_mean
        cls.plot_confidence = plot_confidence
        cls.plot_density = plot_density
        cls.plot_f = plot_f
        cls.plot_errorbars_trainset = plot_errorbars_trainset
        if hasattr(cls, "posterior_samples_f"):
            cls.plot_samples = plot_samples
    SparseGPRegression.plot_inducing = plot_inducing
    # latent-space plots (GPy latent_plots.py family): GPLVM is a GPRegression
    # with latent X, so these attach to both
    for cls in (GPRegression, BayesianGPLVM):
        cls.plot_latent = plot_latent
        cls.plot_latent_scatter = plot_latent_scatter
        cls.plot_magnification = plot_magnification
        cls.plot_steepest_gradient_map = plot_steepest_gradient_map
    BayesianGPLVM.plot_latent_inducing = plot_latent_inducing
    # kernel plots (GPy kernel_plots.py attaches onto Kern)
    Kernel.plot_ARD = plot_ARD
    Kernel.plot_covariance = plot_covariance

"""The torch port's plot family (``utils/plotting_library.py``, the methods
``inject_plotting`` attaches, ``utils/plotting.py`` and ``BO.plot_acquisition``
/ ``plot_convergence``) against the JAX package's, in float64 on the CPU: a
recording backend is put in both packages by monkeypatching (and a recording
pyplot for ``utils/plotting``), and every array a plot hands to it must equal
the JAX package's to rtol 1e-9. Also ``utils/profiling``: ``PhaseTimer`` and a
``torch.profiler`` trace on the CPU."""
import json

import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization as JBO
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models.gp import GPRegression as JGP
from gaussian_process_optimization_tpu.models.gplvm import BayesianGPLVM as JBGPLVM
from gaussian_process_optimization_tpu.models.gplvm import make_gplvm as jmake_gplvm
from gaussian_process_optimization_tpu.models.sparse import SparseGPRegression as JSparse
from gaussian_process_optimization_tpu.models.zoo import GPHeteroscedasticRegression as JHet
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch.utils import native as tnative
from gaussian_process_optimization_tpu.utils import plotting as jplotting
from gaussian_process_optimization_tpu.utils import plotting_library as jpl
import gaussian_process_optimization_tpu_torch.kernels as tk
import gaussian_process_optimization_tpu_torch.models  # noqa: F401  (attaches the plots)
from gaussian_process_optimization_tpu_torch.bo import BayesianOptimization
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression as TGP
from gaussian_process_optimization_tpu_torch.models.gplvm import BayesianGPLVM as TBGPLVM
from gaussian_process_optimization_tpu_torch.models.gplvm import make_gplvm as tmake_gplvm
from gaussian_process_optimization_tpu_torch.models.sparse import SparseGPRegression as TSparse
from gaussian_process_optimization_tpu_torch.utils import plotting as tplotting
from gaussian_process_optimization_tpu_torch.utils import plotting_library as tpl
from gaussian_process_optimization_tpu_torch.utils.profiling import PhaseTimer, trace
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9


CPU = dict(device="cpu")


def _norm(v):
    """A recorded argument: arrays (and tensors) as float arrays, axes and
    figures as a token, anything else as it is."""
    if isinstance(v, torch.Tensor):
        return v.detach().numpy().astype(float)
    if isinstance(v, (np.ndarray, list, tuple)) and np.asarray(v, dtype=object).size and all(
            isinstance(x, (int, float, np.floating, np.integer))
            for x in np.asarray(v, dtype=object).ravel()):
        return np.asarray(v, dtype=float)
    if isinstance(v, _Rec):
        return "<ax>"
    if hasattr(v, "__array__"):
        return np.asarray(v, dtype=float)
    return v


class _Rec:
    """Records every call made on it (and returns None)."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        def call(*args, **kw):
            self._log.append((name, [_norm(a) for a in args],
                              {k: _norm(v) for k, v in sorted(kw.items())}))
        return call


class _Backend:
    """A plotting-library backend that records each primitive's arguments."""

    name = "recording"

    def __init__(self):
        self.log = []

    def figure(self, rows=1, cols=1, figsize=None):
        self.log.append(("figure", [rows, cols], {}))
        return "fig", [_Rec(self.log) for _ in range(rows * cols)]

    def __getattr__(self, name):
        return _Rec(self.log).__getattr__(name)


class _Pyplot(_Rec):
    """A pyplot whose ``subplots`` hands out recording figures and axes."""

    def subplots(self, rows=1, cols=1, **kw):
        self._log.append(("subplots", [rows, cols], {}))
        n = rows * cols
        return _Rec(self._log), (_Rec(self._log) if n == 1 else
                                 tuple(_Rec(self._log) for _ in range(n)))


def assert_same_calls(ours, theirs, rtol=RTOL):
    assert [c[0] for c in ours] == [c[0] for c in theirs]
    for (name, a, k), (_, ja, jk_) in zip(ours, theirs):
        assert len(a) == len(ja) and sorted(k) == sorted(jk_), name
        for x, y in list(zip(a, ja)) + [(k[key], jk_[key]) for key in k]:
            if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float),
                                           rtol=rtol, atol=1e-12, err_msg=name)
            else:
                assert x == y, (name, x, y)


@pytest.fixture
def record(monkeypatch):
    """record(fn_ours, fn_theirs): run each with a recording backend (and a
    recording pyplot) in its package; return both logs."""

    def run(ours, theirs):
        logs = []
        for pl, plotting, fn in ((tpl, tplotting, ours), (jpl, jplotting, theirs)):
            backend = _Backend()
            monkeypatch.setattr(pl, "_current", backend)
            log = backend.log
            monkeypatch.setattr(plotting, "_plt", lambda log=log: _Pyplot(log))
            out = fn()
            logs.append((log, out))
        return logs

    return run


@pytest.fixture(scope="module")
def gp_pair():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (15, 1))
    Y = np.sin(X) + 0.1 * rng.standard_normal((15, 1))
    return (TGP.create(X, Y, kernel=tk.RBF.create(1, **CPU), noise_var=0.05, **CPU),
            JGP.create(X, Y, kernel=jk.RBF.create(1), noise_var=0.05))


@pytest.mark.parametrize("name", ["plot", "plot_data", "plot_mean", "plot_confidence",
                                  "plot_density", "plot_f", "plot_errorbars_trainset"])
def test_gp_plot_family_hands_the_same_arrays(gp_pair, record, name):
    tm, jm = gp_pair
    (ours, _), (theirs, _) = record(lambda: getattr(tm, name)(filename="x.png"),
                                    lambda: getattr(jm, name)(filename="x.png"))
    assert len(ours) > 1
    assert_same_calls(ours, theirs)


def test_plot_samples_draws_from_the_generator(gp_pair, record):
    """The two packages' random streams differ: the grid is the JAX package's,
    and the lines drawn are the port's own posterior draws."""
    tm, jm = gp_pair
    (ours, _), (theirs, _) = record(lambda: tm.plot_samples(samples=2, resolution=20),
                                    lambda: jm.plot_samples(samples=2, resolution=20))
    lines = [c for c in ours if c[0] == "plot"]
    assert len(lines) == 2 == len([c for c in theirs if c[0] == "plot"])
    grid = lines[0][1][1]  # plot(ax, x, y)
    np.testing.assert_allclose(grid, [c for c in theirs if c[0] == "plot"][0][1][1], rtol=RTOL)
    with torch.no_grad():
        S = tm.posterior_samples_f(torch.tensor(grid)[:, None], 2,
                                   generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(np.stack([c[1][2] for c in lines], 1), S.numpy(), rtol=RTOL)


def test_sliced_and_2d_plots_hand_the_same_arrays(record):
    """A 3-D model sliced to one free dim through ``fixed_inputs``, and the 2-D
    contour renderer of ``plot`` (``utils/plotting.plot_gp``)."""
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, (20, 3))
    Y = np.sin(X[:, :1]) + 0.3 * X[:, 1:2]
    tm = TGP.create(X, Y, kernel=tk.RBF.create(3, **CPU), noise_var=0.05, **CPU)
    jm = JGP.create(X, Y, kernel=jk.RBF.create(3), noise_var=0.05)
    fixed = tpl.fixed_inputs(tm, [0], fix_routine="median")
    assert fixed == jpl.fixed_inputs(jm, [0], fix_routine="median")
    (ours, _), (theirs, _) = record(
        lambda: tm.plot(visible_dims=[0], fixed_inputs=fixed, resolution=30),
        lambda: jm.plot(visible_dims=[0], fixed_inputs=fixed, resolution=30))
    assert_same_calls(ours, theirs)
    X2, Y2 = X[:, :2], Y
    tm2 = TGP.create(X2, Y2, kernel=tk.RBF.create(2, **CPU), noise_var=0.05, **CPU)
    jm2 = JGP.create(X2, Y2, kernel=jk.RBF.create(2), noise_var=0.05)
    (ours, _), (theirs, _) = record(lambda: tm2.plot(), lambda: jm2.plot())
    assert any(c[0] == "contourf" for c in ours)
    assert_same_calls(ours, theirs)


def _latent_y():
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(-2, 2, 25))
    return np.stack([np.sin(t), np.cos(t), t], axis=1), (t > 0).astype(int)


def test_gplvm_scatter_and_steepest_gradient_map_hand_the_same_arrays(record):
    """The GPLVM's latent scatter by label and its steepest-gradient map
    (forward mode through the predictive mean)."""
    Y, labels = _latent_y()
    tg, jg = tmake_gplvm(Y, 2, **CPU), jmake_gplvm(Y, 2)
    (ours, _), (theirs, _) = record(lambda: tg.plot_latent_scatter(labels=labels),
                                    lambda: jg.plot_latent_scatter(labels=labels))
    assert_same_calls(ours, theirs)
    (ours, o), (theirs, j) = record(lambda: tg.plot_steepest_gradient_map(resolution=5),
                                    lambda: jg.plot_steepest_gradient_map(resolution=5))
    assert_same_calls(ours, theirs)
    np.testing.assert_allclose(o[1], j[1], rtol=RTOL)


@pytest.mark.slow
def test_gplvm_latent_plot_hands_the_same_arrays(record):
    """The GPLVM's composite latent plot, its magnification through
    ``predict_magnification``. Marked slow: the JAX package's magnification
    runs eagerly, one Jacobian per grid point (~11 s)."""
    Y, labels = _latent_y()
    tg, jg = tmake_gplvm(Y, 2, **CPU), jmake_gplvm(Y, 2)
    (ours, _), (theirs, _) = record(lambda: tg.plot_latent(labels=labels, resolution=6),
                                    lambda: jg.plot_latent(labels=labels, resolution=6))
    assert_same_calls(ours, theirs)


def test_bgplvm_latent_plot_hands_the_same_arrays(record):
    """The Bayesian GPLVM's latent plot: the mean-Jacobian magnification
    (forward mode), the scatter and the inducing overlay."""
    Y, _ = _latent_y()
    tb = TBGPLVM.create(Y, input_dim=2, num_inducing=5, **CPU)
    jb = JBGPLVM.create(Y, input_dim=2, num_inducing=5)
    (ours, _), (theirs, _) = record(lambda: tb.plot_latent(resolution=6),
                                    lambda: jb.plot_latent(resolution=6))
    assert any(c[0] == "contour" for c in ours)
    assert_same_calls(ours, theirs)


def test_kernel_plots_hand_the_same_arrays(record):
    kt = (tk.RBF.create(3, variance=2.0, lengthscale=[1.0, 2.0, 4.0], ARD=True, **CPU)
          + tk.Linear.create(3, variances=[0.5, 0.1, 0.2], ARD=True, **CPU))
    kj = (jk.RBF.create(3, variance=2.0, lengthscale=[1.0, 2.0, 4.0], ARD=True)
          + jk.Linear.create(3, variances=[0.5, 0.1, 0.2], ARD=True))
    (ours, _), (theirs, _) = record(kt.plot_ARD, kj.plot_ARD)
    assert_same_calls(ours, theirs)
    for dim in (1, 2):
        (ours, _), (theirs, _) = record(
            lambda: tk.Matern52.create(dim, **CPU).plot_covariance(resolution=16),
            lambda: jk.Matern52.create(dim).plot_covariance(resolution=16))
        assert_same_calls(ours, theirs)


def test_sparse_and_heteroscedastic_plots_hand_the_same_arrays(record):
    rng = np.random.default_rng(3)
    X = rng.uniform(-2, 2, (20, 1))
    Y = np.sin(X) + 0.1 * rng.standard_normal((20, 1))
    js_ = JSparse.create(X, Y, kernel=jk.RBF.create(1), num_inducing=6, noise_var=0.05)
    ts_ = TSparse.create(X, Y, kernel=tk.RBF.create(1, **CPU), Z=np.array(js_.Z),
                         noise_var=0.05, **CPU)
    for name in ("plot_inducing", "plot_mean"):
        (ours, _), (theirs, _) = record(getattr(ts_, name), getattr(js_, name))
        assert_same_calls(ours, theirs)
    Xh = np.linspace(-2, 2, 12)[:, None]
    Yh = np.sin(Xh) + 0.05 * rng.standard_normal((12, 1))
    noise = np.linspace(0.01, 0.5, 12)
    jh = JHet(Xh, Yh, kernel=jk.RBF.create(1), noise_vars=noise)
    th = TGP.create(Xh, Yh, kernel=tk.RBF.create(1, **CPU), noise_var=noise, **CPU)
    for name in ("plot_errorbars_trainset", "plot_mean"):
        (ours, _), (theirs, _) = record(getattr(th, name), getattr(jh, name))
        assert_same_calls(ours, theirs)


def test_none_backend_and_refusals(gp_pair, tmp_path):
    """'none' draws nothing; an unknown backend and a 1-D latent space raise
    by name; plotly is gated (raises ImportError without the package);
    ``plot_optimizer`` without a trace returns None."""
    tm, _ = gp_pair
    try:
        tpl.change_plotting_library("none")
        assert tm.plot(filename=str(tmp_path / "n.png")) is None
        assert not (tmp_path / "n.png").exists()
        with pytest.raises(ValueError, match="unknown plotting library"):
            tpl.change_plotting_library("ascii-art")
        try:
            import plotly  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError, match="plotly"):
                tpl.change_plotting_library("plotly")
        from gaussian_process_optimization_tpu_torch.ops import lbfgs

        res = lbfgs.minimize(lambda x: torch.sum(x ** 2, dim=-1), torch.ones(1, 2,
                                                                           dtype=torch.float64))
        assert tpl.plot_optimizer(res) is None
    finally:
        tpl.change_plotting_library("matplotlib")
    g = tmake_gplvm(np.stack([np.sin(np.linspace(0, 3, 12)), np.cos(np.linspace(0, 3, 12))],
                             1), 1, **CPU)
    with pytest.raises(ValueError, match="2 latent dim"):
        g.plot_latent_scatter()


def test_plot_optimizer_draws_a_trace(record):
    """``plot_optimizer`` of a one-lane ``minimize(..., trace=True)`` hands the
    same arrays as the JAX package's on its own trace (the unreached
    iterations' NaNs dropped); a Fitter's ``(B, maxiter + 1)`` trace draws one
    line per lane, each as long as its lane ran."""
    import jax.numpy as jnp

    from gaussian_process_optimization_tpu.ops import lbfgs as jlbfgs
    from gaussian_process_optimization_tpu_torch.models.fit import Fitter
    from gaussian_process_optimization_tpu_torch.ops import lbfgs

    A = np.diag([1.0, 10.0, 100.0])
    x0 = np.array([1.0, -1.0, 2.0])
    ours = lbfgs.minimize(lambda X: 0.5 * torch.sum((X @ torch.tensor(A)) * X, -1) - X[:, 0],
                          torch.tensor(x0), maxiter=30, trace=True)
    theirs = jlbfgs.minimize(lambda x: 0.5 * x @ jnp.asarray(A) @ x - x[0], jnp.asarray(x0),
                             maxiter=30, trace=True)
    assert ours.trace.shape == (31,) and int(ours.num_iters) < 30
    (o, fo), (t, ft) = record(lambda: tpl.plot_optimizer(ours), lambda: jpl.plot_optimizer(theirs))
    assert fo == ft == "fig"
    assert_same_calls(o, t)
    plot = next(c for c in o if c[0] == "plot")
    assert len(plot[1][1]) == int(ours.num_iters) + 1  # (ax, iterations, values)
    X, Y = np.linspace(-2, 2, 12)[:, None], np.sin(np.linspace(-2, 2, 12))[:, None]
    m = TGP.create(X, Y, kernel=tk.RBF.create(1, **CPU), noise_var=0.05, **CPU)
    _, res = Fitter(m, num_restarts=3, maxiter=6, tol=0.0, trace=True)(m)
    assert res.trace.shape == (3, 7)
    ((log, fig), _) = record(lambda: tpl.plot_optimizer(res), lambda: None)
    lines = [c for c in log if c[0] == "plot"]
    assert fig == "fig" and len(lines) == 3
    assert [len(c[1][1]) for c in lines] == [int(k) + 1 for k in res.num_iters]


@pytest.mark.slow
def test_bo_plot_acquisition_hands_the_same_arrays(record, monkeypatch):
    """``BO.plot_acquisition`` on forrester after one suggestion (no refit, so
    the suggestions are the JAX package's). The normalized EI curve agrees to
    1e-8: far from the data EI is a difference of nearly equal terms, and the
    two packages' values differ by ~3e-9 of it there. Marked slow: the JAX
    package compiles its loop's programs (~13 s)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)
    kw = dict(f=lambda x: np.asarray(objectives.forrester(x)),
              domain=bounds_to_space(objectives.forrester.bounds), initial_design_numdata=5,
              initial_design_type="latin", exact_feval=True, seed=0, max_iters=0,
              anchor_points_samples=100, anchor_points_num=2)
    ours_bo, theirs_bo = BayesianOptimization(**kw, **CPU), JBO(**kw)
    for bo in (ours_bo, theirs_bo):  # the JAX package plots a fitted loop
        bo.suggest_next_locations()
    (ours, _), (theirs, _) = record(ours_bo.plot_acquisition, theirs_bo.plot_acquisition)
    assert_same_calls(ours, theirs, rtol=1e-8)


def test_plot_convergence_hands_the_same_arrays(record):
    X = np.random.default_rng(4).uniform(size=(6, 2))
    best = np.minimum.accumulate(np.random.default_rng(5).standard_normal(6))
    (ours, _), (theirs, _) = record(lambda: tplotting.plot_convergence(X, best),
                                    lambda: jplotting.plot_convergence(X, best))
    assert_same_calls(ours, theirs)


def test_phase_timer_and_trace_on_the_cpu(tmp_path):
    pt = PhaseTimer()
    x = torch.randn(64, 64, dtype=torch.float64)
    for _ in range(2):
        with pt("mm"):
            pt.sync(x @ x)
    with pt("host"):
        assert pt.sync(3.0) == 3.0
    assert pt.counts == {"mm": 2, "host": 1} and pt.totals["mm"] > 0
    assert "mm" in pt.report() and "2 calls" in pt.report()
    with trace(str(tmp_path / "tr"), cuda=False) as prof:
        torch.linalg.cholesky(x @ x.T + 64 * torch.eye(64, dtype=torch.float64))
    names = {e.key for e in prof.key_averages()}
    assert any("cholesky" in n for n in names)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("cholesky" in str(e.get("name", "")) for e in events)

"""The torch port's acquisitions, cost model, objective and host optimizer
against the JAX package, in float64: EI, MPI and LCB through the GPyOpt host
API (values, gradients, cost, constraints), LP's softplus transform over LCB,
``optimize_host`` with scipy L-BFGS-B, DIRECT and CMA-ES from the same anchors,
and the choice between the device and the host path."""
import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.bo import acquisitions as jacq
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.designs import initial_design
from gaussian_process_optimization_tpu.bo.optimizer import AcquisitionOptimizer as JOptimizer
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models.bo_models import GPModel as JGPModel
from gaussian_process_optimization_tpu_torch.bo import acquisitions as tacq
from gaussian_process_optimization_tpu_torch.bo.cost import CostModel
from gaussian_process_optimization_tpu_torch.bo.objective import SingleObjective
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-9
DOMAIN = bounds_to_space(objectives.branin.bounds)
CONSTRAINTS = [{"name": "c", "constraint": "x[:, 0] + x[:, 1] - 14.0"}]


def _cost(x):
    """A smooth, positive, non-constant cost with its gradient."""
    x = np.atleast_2d(x)
    c = 1.0 + 0.1 * (x[:, :1] + 5.0) + 0.02 * x[:, 1:2] ** 2
    return c, np.hstack([np.full_like(c, 0.1), 0.04 * x[:, 1:2]])


@pytest.fixture(scope="module")
def models():
    """Both packages' surrogates on 12 latin points of branin, not fitted
    (``max_iters=0``): the same posterior."""
    X = initial_design("latin", JSpace(DOMAIN), 12, seed=1)
    Y = np.asarray(objectives.branin(X))
    Y = (Y - Y.mean()) / Y.std()
    jgm = JGPModel(exact_feval=True, max_iters=0)
    tgm = GPModel(exact_feval=True, max_iters=0, device="cpu")
    jgm.updateModel(X, Y)
    tgm.updateModel(X, Y)
    return jgm, tgm


def _acq_pair(name, models, cost=None, constrained=False, **kw):
    jgm, tgm = models
    cons = CONSTRAINTS if constrained else None
    jspace, tspace = JSpace(DOMAIN, cons), DesignSpace(DOMAIN, cons)
    cls = "Acquisition" + name
    return (getattr(jacq, cls)(jgm, jspace, None, cost, **kw),
            getattr(tacq, cls)(tgm, tspace, None, cost, **kw))


def _points(rng, n=9):
    lo, hi = np.array(objectives.branin.bounds).T
    return lo + rng.uniform(size=(n, 2)) * (hi - lo)


CASES = {
    "EI": ("EI", {}), "EI_jitter": ("EI", {"jitter": 0.2}),
    "MPI": ("MPI", {}), "MPI_jitter": ("MPI", {"jitter": 0.3}),
    "LCB": ("LCB", {}), "LCB_weight": ("LCB", {"exploration_weight": 0.5}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_acquisition_value_and_gradient_match_jax(case, models, rng):
    """``_compute_acq`` and ``_compute_acq_withGradients`` at 9 points, 1e-9."""
    name, kw = CASES[case]
    ja, ta = _acq_pair(name, models, **kw)
    X = _points(rng)
    np.testing.assert_allclose(ta._compute_acq(X), ja._compute_acq(X), rtol=RTOL, atol=1e-300)
    f, df = ta._compute_acq_withGradients(X)
    jf, jdf = ja._compute_acq_withGradients(X)
    assert f.shape == (9, 1) and df.shape == (9, 2)
    np.testing.assert_allclose(f, jf, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(df, jdf, rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("name", ["EI", "MPI", "LCB"])
@pytest.mark.parametrize("setting", ["plain", "cost", "cost+constraint"])
def test_host_api_matches_jax(name, setting, models, rng, capsys):
    """``acquisition_function`` = -(raw * indicator) / cost and its gradient;
    LCB ignores the cost (and says so), as GPyOpt's does."""
    cost = _cost if "cost" in setting else None
    ja, ta = _acq_pair(name, models, cost=cost, constrained="constraint" in setting)
    assert ta.has_cost == ja.has_cost == (cost is not None and name != "LCB")
    if name == "LCB" and cost is not None:
        assert "ignored" in capsys.readouterr().out
    X = _points(rng)
    np.testing.assert_allclose(ta.acquisition_function(X), ja.acquisition_function(X),
                               rtol=RTOL, atol=1e-300)
    f, df = ta.acquisition_function_withGradients(X)
    jf, jdf = ja.acquisition_function_withGradients(X)
    np.testing.assert_allclose(f, jf, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(df, jdf, rtol=RTOL, atol=1e-14)
    if "constraint" in setting:
        assert np.any(f == 0) and np.any(f != 0)  # points on both sides of the constraint


@pytest.mark.parametrize("scale", [1.0, 25.0], ids=["softplus", "above_40"])
def test_lp_over_lcb_matches_jax(scale, models, rng):
    """LP wraps LCB in softplus before the log; with the exploration weight
    scaled up the raw value passes 40, where the transform is the identity:
    values and gradients agree on both sides and no gradient is NaN."""
    jgm, tgm = models
    ja, ta = _acq_pair("LCB", models, exploration_weight=2 * scale)
    jlp = jacq.AcquisitionLP(jgm, ja.space, None, ja)
    tlp = tacq.AcquisitionLP(tgm, ta.space, None, ta)
    assert tlp.transform == jlp.transform == "softplus"
    X_batch, X = _points(rng, 3), _points(rng, 10)
    X[:3] = tgm.model.X[:3].numpy() + 0.05  # near the data the std is small
    for lp in (jlp, tlp):
        lp.update_batches(X_batch, 2.5, -1.2)
    if scale > 1:
        assert np.any(ta._compute_acq(X) >= 40.0) and np.any(ta._compute_acq(X) < 40.0)
    f, df = tlp.acquisition_function_withGradients(X)
    jf, jdf = jlp.acquisition_function_withGradients(X)
    assert np.all(np.isfinite(df))
    np.testing.assert_allclose(f, jf, rtol=RTOL)
    np.testing.assert_allclose(df, jdf, rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(tlp.acquisition_function(X), jlp.acquisition_function(X),
                               rtol=RTOL)


def test_lp_transform_argument(models):
    _, tgm = models
    _, ei = _acq_pair("EI", models)
    assert tacq.AcquisitionLP(tgm, ei.space, None, ei).transform == "none"
    assert tacq.AcquisitionLP(tgm, ei.space, None, ei, transform="Softplus").transform == \
        "softplus"


def _optimizers(name, space_kw=None, **kw):
    cons = space_kw or None
    return (JOptimizer(JSpace(DOMAIN, cons), name, **kw),
            AcquisitionOptimizer(DesignSpace(DOMAIN, cons), name, **kw))


@pytest.mark.parametrize("name,acq,cost", [("lbfgs_host", "EI", None), ("lbfgs_host", "LCB", None),
                                           ("lbfgs", "EI", _cost), ("DIRECT", "EI", None),
                                           ("CMA", "MPI", None)])
def test_optimize_host_matches_jax(name, acq, cost, models):
    """The host path from the same 200-point sweep and 3 anchors: the same
    argmin, 1e-6, and the same value."""
    ja, ta = _acq_pair(acq, models, cost=cost)
    jopt, topt = _optimizers(name, num_samples=200, num_anchor=3, maxiter=40)
    jx, jf = jopt.optimize_host(f=ja.acquisition_function,
                                f_df=ja.acquisition_function_withGradients)
    tx, tf = topt.optimize(f=ta.acquisition_function,
                           f_df=ta.acquisition_function_withGradients, acquisition=ta)
    assert tx.shape == (1, 2) and tf.shape == (1, 1)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-9)


def test_device_path_matches_jax(models):
    """'lbfgs' without a cost takes the device path in both packages."""
    ja, ta = _acq_pair("MPI", models)
    jopt, topt = _optimizers("lbfgs", num_samples=200, num_anchor=3, maxiter=40,
                             design_type="sobol")
    ja.optimizer, ta.optimizer = jopt, topt
    jx, jf = ja.optimize()
    tx, tf = ta.optimize()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tf, jf, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,cost,host", [("lbfgs", None, False), ("lbfgs", _cost, True),
                                            ("lbfgs_host", None, True), ("CMA", None, True)])
def test_optimize_chooses_its_path(name, cost, host, models, monkeypatch):
    """The host path when the acquisition has a cost or the optimizer is not
    'lbfgs' (optimizer.py:150-162)."""
    _, ta = _acq_pair("EI", models, cost=cost)
    _, topt = _optimizers(name, num_samples=50, num_anchor=2, maxiter=5)
    calls = []
    monkeypatch.setattr(topt, "optimize_host", lambda **kw: calls.append("host") or (0, 0))
    monkeypatch.setattr(topt, "_optimize_device", lambda *a: calls.append("device") or (0, 0))
    topt.optimize(f=ta.acquisition_function, acquisition=ta)
    assert calls == ["host" if host else "device"]


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown acquisition optimizer"):
        AcquisitionOptimizer(DesignSpace(DOMAIN), "adam")


def test_cost_model_kinds(rng):
    x = _points(rng, 4)
    const = CostModel(None)
    assert const.cost_type == "constant"
    c, dc = const.cost_withGradients(x)
    assert np.all(c == 1.0) and c.shape == (4, 1) and not dc.any()
    user = CostModel(_cost)
    assert user.cost_type == "user_defined" and user.cost_withGradients is _cost


def test_evaluation_time_cost_model(rng):
    """A GP on log cost, on the device and in the dtype it is given: the unit
    cost before any data, then exp(mean) with its gradient by the chain rule."""
    cm = CostModel("evaluation_time", device="cpu", dtype=torch.float64)
    assert cm.cost_model.device == torch.device("cpu")
    x = _points(rng, 8)
    c, dc = cm.cost_withGradients(x[:2])
    assert np.all(c == 1.0) and not dc.any()
    seconds = 0.5 + 0.05 * (x[:, :1] + 5.0)
    cm.update_cost_model(x[:5], seconds[:5])
    cm.update_cost_model(x[5:], seconds[5:])
    assert cm.num_updates == 2 and cm.cost_X.shape == (8, 2)
    assert cm.cost_model.model.X.dtype == torch.float64
    c, dc = cm.cost_withGradients(x)
    assert c.shape == (8, 1) and dc.shape == (8, 2)
    np.testing.assert_allclose(c, seconds, rtol=0.2)  # it learned the cost's scale
    m, _, dm, _ = cm.cost_model.predict_withGradients(x)
    np.testing.assert_allclose(dc, np.exp(m) * dm, rtol=1e-12)
    np.testing.assert_allclose(cm._cost_gp(x), c, rtol=1e-12)


def _slow_square(x):
    return np.sum(np.atleast_2d(x) ** 2, axis=1, keepdims=True)


def test_single_objective_serial(rng):
    """Row-wise values with per-row seconds."""
    x = rng.uniform(-1, 1, (5, 3))
    f, cost = SingleObjective(_slow_square, num_cores=1).evaluate(x)
    np.testing.assert_allclose(f, _slow_square(x), rtol=1e-15)
    assert cost.shape == (5, 1) and np.all(cost >= 0)


_FAN_OUT = """
import numpy as np
from gaussian_process_optimization_tpu_torch.bo.objective import SingleObjective

def square(x):
    return np.sum(np.atleast_2d(x) ** 2, axis=1, keepdims=True)

x = np.random.default_rng(0).uniform(-1, 1, (5, 3))
obj = SingleObjective(square, num_cores=2)
f, cost = obj.evaluate(x)
assert not hasattr(obj, "parallel_error")
assert np.allclose(f, square(x), rtol=1e-15) and np.all(cost == 1.0) and cost.shape == (5, 1)
print("fan-out ok")
"""


def test_single_objective_over_two_processes():
    """``num_cores=2``: the same values, and the constant cost GPyOpt sets for
    a parallel batch. Run in an interpreter of its own, so the fork happens in
    a process without this test session's threads."""
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", _FAN_OUT], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parent.parent)
    assert out.returncode == 0 and "fan-out ok" in out.stdout, out.stderr[-2000:]


def test_single_objective_falls_back_to_serial(rng, capsys):
    """An objective that cannot cross a process boundary is evaluated serially."""
    x = rng.uniform(-1, 1, (4, 2))
    obj = SingleObjective(lambda v: _slow_square(v), num_cores=2)
    obj._syncronous_batch_evaluation = lambda x: (_ for _ in ()).throw(RuntimeError("boom"))
    f, _ = obj.evaluate(x)
    np.testing.assert_allclose(f, _slow_square(x))
    assert "Fall back" in capsys.readouterr().out and obj.parallel_error

"""The torch port's pool batches, helpers, CLI and serialization against the JAX package, in
float64: pool scoring and batch selection with local-penalization re-scoring
(``bo/pool.py``; scores rel 1e-9, the same picks), the GPyOpt helpers of
``bo/general.py`` (rel 1e-9), the JSON config and command line of
``bo/interface.py`` on a temporary experiment, and ``utils/serialization.py``
(models round-trip bit for bit; an ``.npz`` written by the JAX package resumes
a BO in the port)."""
import json

import numpy as np
import pytest
import torch

from gaussian_process_optimization_tpu.bo import acquisitions as jacq
from gaussian_process_optimization_tpu.bo import general as jgeneral
from gaussian_process_optimization_tpu.bo import interface as jinterface
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo import pool as jpool
from gaussian_process_optimization_tpu.bo.designs import initial_design
from gaussian_process_optimization_tpu.bo.optimizer import AcquisitionOptimizer as JOptimizer
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models.bo_models import GPModel as JGPModel
from gaussian_process_optimization_tpu_torch import workload
from gaussian_process_optimization_tpu_torch.bo import acquisitions as tacq
from gaussian_process_optimization_tpu_torch.bo import general, interface, pool
from gaussian_process_optimization_tpu_torch.bo.methods import BayesianOptimization
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from gaussian_process_optimization_tpu_torch.models.classification import GPClassification
from gaussian_process_optimization_tpu_torch.models.gp import GPRegression
from gaussian_process_optimization_tpu_torch.models.tp import TPRegression
from gaussian_process_optimization_tpu_torch.utils import serialization as ser
from torch_threads import one_torch_thread  # noqa: F401

DOMAIN = bounds_to_space(objectives.branin.bounds)
CONSTRAINTS = [{"name": "c", "constraint": "x[:, 0] + x[:, 1] - 14.0"}]


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
    return jgm, tgm, X, Y


def _pool(n=60, seed=3):
    lo, hi = np.array(objectives.branin.bounds).T
    return lo + np.random.default_rng(seed).uniform(size=(n, 2)) * (hi - lo)


def _acqs(models, lp, constrained=False):
    jgm, tgm = models[:2]
    cons = CONSTRAINTS if constrained else None
    jspace, tspace = JSpace(DOMAIN, cons), DesignSpace(DOMAIN, cons)
    ja = jacq.AcquisitionEI(jgm, jspace, JOptimizer(jspace))
    ta = tacq.AcquisitionEI(tgm, tspace, AcquisitionOptimizer(tspace))
    if lp:
        ja = jacq.AcquisitionLP(jgm, jspace, JOptimizer(jspace), ja)
        ta = tacq.AcquisitionLP(tgm, tspace, AcquisitionOptimizer(tspace), ta)
    return ja, ta, jspace, tspace


@pytest.mark.parametrize("constrained", [False, True])
def test_score_pool_matches_jax(models, constrained):
    ja, ta, jspace, tspace = _acqs(models, lp=False, constrained=constrained)
    P = _pool()
    js, _ = jpool.score_pool(ja, P, jspace)
    ts, Xm = pool.score_pool(ta, P, tspace)
    assert np.array_equal(np.isinf(ts), np.isinf(js))
    assert np.isinf(ts).any() == constrained
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts[fin], js[fin], rtol=1e-9)
    np.testing.assert_array_equal(Xm, P)


@pytest.mark.parametrize("lp", [False, True])
def test_suggest_from_pool_matches_jax(models, lp):
    """A batch of 4 (LP re-scores after each pick), then 2 more with the first
    batch excluded: the same indices as the JAX package's."""
    ja, ta, jspace, tspace = _acqs(models, lp=lp)
    P = _pool()
    jidx, jrows = jpool.suggest_from_pool(ja, P, jspace, batch_size=4)
    tidx, trows = pool.suggest_from_pool(ta, P, tspace, batch_size=4)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(trows, P[tidx])
    assert len(set(tidx.tolist())) == 4
    if lp:
        assert ta.X_batch is None  # the batch state is cleared after the picks
    mask = np.zeros(len(P), dtype=bool)
    mask[tidx] = True
    t2, _ = pool.suggest_from_pool(ta, P, tspace, batch_size=2, exclude_mask=mask)
    j2, _ = jpool.suggest_from_pool(ja, P, jspace, batch_size=2, exclude_mask=mask)
    np.testing.assert_array_equal(t2, j2)
    assert not set(t2.tolist()) & set(tidx.tolist())


def test_metamodel_rmse_and_shuffle_match_jax(models):
    jgm, tgm, X, Y = models
    Xt = _pool(9, seed=5)
    Yt = np.asarray(objectives.branin(Xt))
    assert pool.metamodel_rmse(tgm, Xt, Yt) == pytest.approx(
        jpool.metamodel_rmse(jgm, Xt, Yt), rel=1e-9)
    variables = [{"name": "a", "type": "continuous", "domain": (0, 1)},
                 {"name": "b", "type": "discrete", "domain": (1, 2, 5, 7)},
                 {"name": "c", "type": "discrete", "domain": (0, 3, 4)}]
    rng = np.random.default_rng(0)
    X3 = np.column_stack([rng.uniform(size=20), rng.choice([1, 2, 5, 7], 20),
                          rng.choice([0, 3, 4], 20)]).astype(float)
    got, pat = pool.shuffle_indices(X3, variables, rng=np.random.default_rng(9))
    want, jpat = jpool.shuffle_indices(X3, variables, rng=np.random.default_rng(9))
    np.testing.assert_array_equal(got, want)
    assert pat == jpat
    np.testing.assert_array_equal(pool.unshuffle_indices(got, variables, pat), X3)


GENERAL = {
    "reshape": lambda g, ms, x: g.reshape(x[0], 2),
    "best_value": lambda g, ms, x: g.best_value(x[:, 0]),
    "best_value_max": lambda g, ms, x: g.best_value(x[:, 1], sign=-1),
    "best_guess": lambda g, ms, x: g.best_guess(lambda a: np.asarray(objectives.branin(a)), x),
    "uniform": lambda g, ms, x: g.samples_multidimensional_uniform(
        objectives.branin.bounds, 5, rng=np.random.default_rng(2)),
    "values_to_array": lambda g, ms, x: g.values_to_array((1.0, 2.0, 3.0)),
    "merge_values": lambda g, ms, x: g.merge_values(x[:2], np.array([[7.0], [8.0]])),
    "normalize_stats": lambda g, ms, x: g.normalize(x[:, 0]),
    "normalize_maxmin": lambda g, ms, x: g.normalize(x[:, :1], "maxmin"),
    "get_moments": lambda g, ms, x: g.get_moments(ms, x),
    "get_d_moments": lambda g, ms, x: g.get_d_moments(ms, x),
    "get_moments_bare": lambda g, ms, x: g.get_moments(ms.model, x),
    "get_d_moments_bare": lambda g, ms, x: g.get_d_moments(ms.model, x),
}


@pytest.mark.parametrize("name", list(GENERAL))
def test_general_helpers_match_jax(models, name):
    jgm, tgm = models[:2]
    x = _pool(6, seed=8)
    got = GENERAL[name](general, tgm, x)
    want = GENERAL[name](jgeneral, jgm, x)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float),
                                   rtol=1e-9, atol=1e-12)


def test_integrated_acquisition_is_the_acquisition(models):
    _, ta, _, _ = _acqs(models, lp=False)
    x = _pool(4, seed=2)
    np.testing.assert_array_equal(general.compute_integrated_acquisition(ta, x),
                                  ta.acquisition_function(x))
    for a, b in zip(general.compute_integrated_acquisition_withGradients(ta, x),
                    ta.acquisition_function_withGradients(x)):
        np.testing.assert_array_equal(a, b)


OBJECTIVE = """import numpy as np


def f(x):
    x = np.atleast_2d(x)
    a, b, c = 1.0, 5.1 / (4 * np.pi ** 2), 5.0 / np.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
    return (a * (x[:, 1:2] - b * x[:, :1] ** 2 + c * x[:, :1] - r) ** 2
            + s * (1 - t) * np.cos(x[:, :1]) + s)
"""


def _experiment(tmp_path, **extra):
    (tmp_path / "objective.py").write_text(OBJECTIVE)
    cfg = {"main-file": "objective.py", "likelihood": "noiseless",
           "model": {"optimization-restarts": 1, "optimization-iterations": 20},
           "space": [{"name": "x1", "type": "continuous", "domain": [-5, 10]},
                     {"name": "x2", "type": "continuous", "domain": [0, 15]}],
           "initialization": {"type": "latin", "num-eval": 5},
           "resources": {"maximum-iterations": 2},
           "output": {"file-report": str(tmp_path / "report.txt"),
                      "file-evaluations": str(tmp_path / "evaluations.txt"),
                      "file-models": str(tmp_path / "models.txt")}, **extra}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return path, cfg


def test_config_schema_is_the_references():
    assert interface.default_config() == jinterface.default_config()
    new = {"model": {"type": "sparseGP"}, "space": [1]}
    assert (interface.update_config(new, interface.default_config())
            == jinterface.update_config(new, jinterface.default_config()))


def test_command_line_runs_an_experiment(tmp_path, capsys):
    """``main`` on a config that names the CPU: 5 initial and 2 BO
    evaluations, the report, evaluations and models files written."""
    path, _ = _experiment(tmp_path, device="cpu")
    assert interface.main([str(path)]) == 0
    assert "Best found" in capsys.readouterr().out
    rows = (tmp_path / "evaluations.txt").read_text().strip().splitlines()
    assert len(rows) == 1 + 7 and rows[0].startswith("Iteration\tY")
    assert "Value at minimum" in (tmp_path / "report.txt").read_text()
    assert len((tmp_path / "models.txt").read_text().strip().splitlines()) >= 2
    assert interface.main([]) == 1


def test_bodriver_objective_and_device(tmp_path):
    """The objective the config names is the JAX package's loaded one; the
    caller's device wins over the config's."""
    path, cfg = _experiment(tmp_path, device="meta")
    f = interface.load_objective(cfg, str(tmp_path))
    x = np.array([[1.0, 2.0], [3.0, 4.0]])
    np.testing.assert_allclose(f(x), jinterface.load_objective(cfg, str(tmp_path))(x))
    assert interface.BODriver(cfg, f, device="cpu").device == torch.device("cpu")
    assert interface.BODriver(cfg, f).device == torch.device("meta")
    bo = interface.BODriver({**cfg, "device": "cpu"}, f).run()
    assert bo.Y.shape == (7, 1) and bo.model.device == torch.device("cpu")


def _models_to_save():
    X, Y = workload.bench_data(n=10, d=2)
    return {"GPRegression": GPRegression.create(X, Y, max_points=16, device="cpu"),
            "GPClassification": GPClassification.create(X, Y, device="cpu"),
            "TPRegression": TPRegression.create(X, Y, device="cpu"),
            "SVGP": workload.svgp_probe(workload.svgp_model(X, Y, num_inducing=4,
                                                            device="cpu"))}


@pytest.mark.parametrize("name", ["GPRegression", "GPClassification", "TPRegression", "SVGP"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_model_round_trip_is_exact(tmp_path, name, dtype):
    """save_model / load_model: the same dtypes, and the evidence bit for bit."""
    from gaussian_process_optimization_tpu_torch.utils.tree import named_leaves, tree_map

    model = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                     _models_to_save()[name])
    path = tmp_path / "m.json.gz"
    ser.save_model(model, path)
    back = ser.load_model(path, device="cpu")
    for (p, a), (q, b) in zip(named_leaves(model), named_leaves(back)):
        assert p == q and a.dtype == b.dtype and torch.equal(a, b)

    def evidence(m):
        with torch.no_grad():
            if name == "SVGP":
                return m.elbo(m.Z, m.q_mu)
            return m.log_marginal_likelihood()

    assert torch.equal(evidence(back), evidence(model))
    plain = tmp_path / "m.json"
    ser.save_model(model, plain, compress=False)
    assert torch.equal(evidence(ser.load_model(plain, device="cpu")), evidence(model))


def test_checkpoint_names_only_this_package():
    bad = {"__class__": "os.system", "fields": {}}
    with pytest.raises(ValueError, match="refusing"):
        ser.from_dict(bad, device="cpu")
    with pytest.raises(ValueError, match="refusing"):
        ser.from_dict({"__class__": "gaussian_process_optimization_tpu.models.gp.GPRegression",
                       "fields": {}}, device="cpu")


def test_jax_bo_state_resumes_in_the_port(tmp_path):
    """The JAX package's ``save_bo_state`` after a suggestion; the port loads
    it, its parameter row has the port's ``get_model_parameters`` order and
    width, and a BO built on the loaded history suggests a point in the box
    and saves the same kind of file."""
    from gaussian_process_optimization_tpu.bo import BayesianOptimization as JBO
    from gaussian_process_optimization_tpu.utils import serialization as jser

    domain = [{"name": "x", "type": "continuous", "domain": (0.0, 1.0)}]
    X = np.random.default_rng(0).uniform(0, 1, size=(8, 1))
    Y = np.asarray(objectives.forrester(X))
    jbo = JBO(f=None, domain=domain, X=X, Y=Y, exact_feval=True, max_iters=30)
    jbo.suggest_next_locations()
    path = tmp_path / "state.npz"
    jser.save_bo_state(jbo, path)
    X2, Y2, params = ser.load_bo_state(path)
    np.testing.assert_array_equal(X2, X)
    np.testing.assert_array_equal(Y2, Y)
    tbo = BayesianOptimization(f=None, domain=domain, X=X2, Y=Y2, exact_feval=True,
                               max_iters=30, device="cpu")
    x_next = tbo.suggest_next_locations()
    assert 0.0 <= x_next[0, 0] <= 1.0
    names = tbo.model.get_model_parameters_names()
    assert params.shape == (len(names),) == tbo.model.get_model_parameters()[0].shape
    assert names == jbo.model.get_model_parameters_names()
    ser.save_bo_state(tbo, tmp_path / "again.npz")
    X3, Y3, p3 = jser.load_bo_state(tmp_path / "again.npz")
    np.testing.assert_array_equal(X3, X)
    assert p3.shape == params.shape

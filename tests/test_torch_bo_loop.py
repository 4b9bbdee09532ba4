"""The torch port's tell-and-ask loop against the JAX package, in float64:
whole ``run_optimization`` runs for EI, MPI and LCB, the random and Thompson
batches, the composite slice (``Add`` kernel, mean function, LCB, Sobol
anchors), every option ``BayesianOptimization`` accepts for ``model_type="GP"``
and what it refuses by name, the reports, and the regret runner."""
import json

import numpy as np
import pytest
import torch

import gaussian_process_optimization_tpu.kernels as jk
from gaussian_process_optimization_tpu.bo import acquisitions as jacq
from gaussian_process_optimization_tpu.bo import evaluators as jev
from gaussian_process_optimization_tpu.bo import objectives
from gaussian_process_optimization_tpu.bo.methods import BayesianOptimization as JBO
from gaussian_process_optimization_tpu.bo.methods import ModularBayesianOptimization as JModular
from gaussian_process_optimization_tpu.bo.objective import SingleObjective as JObjective
from gaussian_process_optimization_tpu.bo.optimizer import AcquisitionOptimizer as JOptimizer
from gaussian_process_optimization_tpu.bo.space import DesignSpace as JSpace
from gaussian_process_optimization_tpu.bo.space import bounds_to_space
from gaussian_process_optimization_tpu.models import mean_functions as jmf
from gaussian_process_optimization_tpu.models.bo_models import GPModel as JGPModel
from gaussian_process_optimization_tpu.utils import native
from gaussian_process_optimization_tpu_torch import regret, workload
from gaussian_process_optimization_tpu_torch.bo import (BayesianOptimization,
                                                        ModularBayesianOptimization)
from gaussian_process_optimization_tpu_torch.bo import acquisitions as tacq
from gaussian_process_optimization_tpu_torch.bo import evaluators as tev
from gaussian_process_optimization_tpu_torch.bo.objective import SingleObjective
from gaussian_process_optimization_tpu_torch.bo.optimizer import AcquisitionOptimizer
from gaussian_process_optimization_tpu_torch.bo.space import DesignSpace
from gaussian_process_optimization_tpu_torch.bo.variables import InvalidConfigError
from gaussian_process_optimization_tpu_torch.models.bo_models import GPModel
from torch_threads import one_torch_thread  # noqa: F401

DOMAIN = bounds_to_space(objectives.branin.bounds)


def branin(x):
    return np.asarray(objectives.branin(x))


@pytest.fixture(autouse=True)
def numpy_branch(monkeypatch):
    """Hold the reference's designs to their numpy branch (the port has no
    native engine)."""
    monkeypatch.setattr(native, "available", lambda: False)


def _common(**kw):
    base = dict(f=branin, domain=DOMAIN, initial_design_numdata=5, initial_design_type="latin",
                exact_feval=True, seed=0, max_iters=0)
    base.update(kw)
    return base


@pytest.mark.parametrize("acquisition", ["EI", "MPI", "LCB"])
def test_whole_loop_matches_jax(acquisition):
    """``run_optimization(max_iter=3, eps=-1)`` on branin from a latin design
    of 5, no refit: the JAX package's X and Y, 1e-6, and its bookkeeping."""
    kw = _common(acquisition_type=acquisition)
    theirs = JBO(**kw)
    theirs.run_optimization(max_iter=3, eps=-1)
    ours = BayesianOptimization(**kw, device="cpu")
    ours.run_optimization(max_iter=3, eps=-1)
    assert ours.X.shape == (8, 2) and ours.num_acquisitions == 3
    np.testing.assert_array_equal(ours.X[:5], theirs.X[:5])  # the latin design
    np.testing.assert_allclose(ours.X, theirs.X, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.Y, theirs.Y, rtol=1e-6, atol=1e-6)
    assert ours.fx_opt == pytest.approx(theirs.fx_opt, rel=1e-6)
    np.testing.assert_allclose(ours.Y_best, theirs.Y_best, rtol=1e-6)
    np.testing.assert_allclose(ours.x_opt, theirs.x_opt, atol=1e-6)
    np.testing.assert_allclose(ours.model_parameters_iterations,
                               theirs.model_parameters_iterations, rtol=1e-12)
    assert ours.model.get_model_parameters_names() == theirs.model.get_model_parameters_names()
    assert not ours._fit_failed and set(ours.seconds) == {"fit", "acquisition", "objective"}


@pytest.mark.parametrize("kw", [dict(acquisition_jitter=0.2), dict(acquisition_type="LCB",
                                                                   acquisition_weight=0.5),
                                dict(anchor_points_design="sobol", anchor_points_samples=2000,
                                     anchor_points_num=4),
                                dict(acquisition_optimizer_type="lbfgs_host",
                                     anchor_points_samples=50, anchor_points_num=1),
                                dict(maximize=True), dict(normalize_Y=False),
                                dict(model_update_interval=2)],
                         ids=["jitter", "weight", "anchor_points", "host_optimizer", "maximize",
                              "raw_Y", "update_interval"])
def test_loop_options_match_jax(kw):
    """Two iterations under each option the loop reads: the same X and Y."""
    kw = _common(**kw)
    theirs = JBO(**kw)
    theirs.run_optimization(max_iter=2, eps=-1)
    ours = BayesianOptimization(**kw, device="cpu")
    ours.run_optimization(max_iter=2, eps=-1)
    np.testing.assert_allclose(ours.X, theirs.X, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.Y, theirs.Y, rtol=1e-6, atol=1e-6)


def test_stopping_rules():
    """max_iter 0 fits and stops; a positive eps stops on two close points;
    max_time 0 never enters the loop."""
    bo = BayesianOptimization(**_common(), device="cpu")
    bo.run_optimization(max_iter=0)
    assert bo.X.shape == (5, 2) and bo.model.posterior is not None
    X = np.array([[0.0, 5.0], [1.0, 6.0], [1.0, 6.0 + 1e-9]])
    bo = BayesianOptimization(**_common(X=X, Y=branin(X)), device="cpu")
    bo.run_optimization(max_iter=5, eps=1e-6)
    assert bo.X.shape == (3, 2)
    bo.run_optimization(max_iter=5, max_time=0.0)
    assert bo.num_acquisitions == 0


@pytest.mark.parametrize("evaluator", ["random", "thompson_sampling"])
@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "dedup"])
def test_sampling_batches_match_jax(evaluator, dedup, monkeypatch):
    """A batch of 4 on a continuous and discrete space: shape, box, allowed
    levels, distinct rows, and the JAX package's batch. Both packages draw
    these evaluators' anchor candidates from an unseeded generator, so a seed
    is injected into both; the Thompson scores' normals are seeded by both."""
    from gaussian_process_optimization_tpu.bo import anchor_points as janchor
    from gaussian_process_optimization_tpu_torch.bo import anchor_points as tanchor

    for mod in (janchor, tanchor):
        real = mod.initial_design
        monkeypatch.setattr(mod, "initial_design", lambda *a, seed=None, _real=real, **kw: _real(
            *a, seed=17 if seed is None else seed, **kw))
    domain = [{"name": "x", "type": "continuous", "domain": (-5.0, 10.0)},
              {"name": "d", "type": "discrete", "domain": (1, 3, 5, 7, 9, 11, 13, 15)}]
    kw = _common(domain=domain, evaluator_type=evaluator, batch_size=4, de_duplication=dedup,
                 initial_design_numdata=6)
    theirs = JBO(**kw).suggest_next_locations()
    bo = BayesianOptimization(**kw, device="cpu")
    ours = bo.suggest_next_locations()
    cls = tev.RandomBatch if evaluator == "random" else tev.ThompsonBatch
    assert isinstance(bo.evaluator, cls) and bo.evaluator.num_anchor == 20
    assert ours.shape == (4, 2)
    assert np.all((ours[:, 0] >= -5.0) & (ours[:, 0] <= 10.0))
    assert set(ours[:, 1]) <= {1.0, 3.0, 5.0, 7.0, 9.0, 11.0, 13.0, 15.0}
    assert len({tuple(r) for r in ours}) == 4
    if dedup:
        assert not {tuple(r) for r in ours} & {tuple(r) for r in bo.X}
    np.testing.assert_array_equal(ours[:, 1], theirs[:, 1])
    # random: the argmax and raw anchors; thompson: each row the end of an L-BFGS
    # path from a far anchor to a flat optimum, equal to the solver's tolerance
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], rtol=0,
                               atol=1e-6 if evaluator == "random" else 1e-4)


def test_thompson_anchor_polish_is_one_lbfgs_lane():
    """``optimize_anchor_point`` from one anchor: the JAX per-anchor L-BFGS."""
    kw = _common(evaluator_type="thompson_sampling", batch_size=2)
    jbo, tbo = JBO(**kw), BayesianOptimization(**kw, device="cpu")
    for bo in (jbo, tbo):
        bo._update_model()
    a = np.array([2.0, 4.0])
    ours = tbo.evaluator.optimize_anchor_point(a)
    theirs = np.asarray(jbo.evaluator.optimize_anchor_point(a))
    assert ours.shape == (1, 2)
    # a long path to a flat optimum: the same optimum, to the solver's tolerance
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tbo.acquisition.acquisition_function(ours),
                               jbo.acquisition.acquisition_function(theirs), rtol=1e-6)


def _composite_jax(X, Y, d):
    """The JAX package's twin of ``workload.composite_bo``, by its modular API
    (its ``BayesianOptimization`` does not hand a mean function on)."""
    space = JSpace(bounds_to_space([workload.BOX] * d))
    kern = jk.Matern52.create(d, ARD=True) + jk.RBF.create(1, active_dims=(0,))
    model = JGPModel(kernel=kern, max_iters=0, mean_function=jmf.Constant.create(d))
    opt = JOptimizer(space, "lbfgs", model=model, design_type="sobol")
    acq = jacq.AcquisitionLCB(model, space, opt, None, 2)
    return JModular(model, space, JObjective(workload.bench_function), acq,
                    jev.Sequential(acq), X_init=X, Y_init=Y)


def test_composite_slice_matches_jax():
    """The composite path at N=40, no refit: an ``Add`` of an ARD Matern52 and
    a sliced RBF, a constant mean, LCB from Sobol anchors, two iterations of
    the loop: the JAX package's X and Y, 1e-6."""
    X, Y = workload.bench_data(n=40, d=4, seed=2)
    theirs = _composite_jax(X, Y, 4)
    theirs.run_optimization(max_iter=2, eps=-1)
    ours = workload.composite_bo(X, Y, steps=0, device="cpu", dtype=torch.float64)
    ours.run_optimization(max_iter=2, eps=-1)
    kern = ours.model.model.kern
    assert [type(p).__name__ for p in kern.parts] == ["Matern52", "RBF"]
    assert kern.parts[1].active_dims == (0,) and ours.model.priors.keys() == {
        "lengthscale", "variance"}
    assert ours.X.shape == (42, 4) and np.all(np.abs(ours.X) <= 2.0)
    np.testing.assert_allclose(ours.X, theirs.X, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours.Y, theirs.Y, rtol=1e-6, atol=1e-6)


def test_composite_fit_uses_the_priors(monkeypatch):
    """With ``steps > 0`` the refit's objective carries the priors, and the
    fitted kernel moves both parts' leaves and the mean function's constant."""
    X, Y = workload.bench_data(n=24, d=3, seed=1)
    bo = workload.composite_bo(X, Y, restarts=2, steps=4, device="cpu", dtype=torch.float64)
    seen = []
    from gaussian_process_optimization_tpu_torch.models import bo_models

    real = bo_models.Fitter

    def spy(*a, **kw):
        seen.append(kw.get("priors"))
        return real(*a, **kw)

    monkeypatch.setattr(bo_models, "Fitter", spy)
    x = bo.suggest_next_locations()
    assert x.shape == (1, 3) and seen and set(seen[0]) == {"lengthscale", "variance"}
    m = bo.model.model
    assert float(m.mean_function.C) != 0.0
    assert all(float(p.variance) != 1.0 for p in m.kern.parts)


def test_modular_equals_the_one_stop_api():
    kw = _common(acquisition_type="MPI")
    ref = BayesianOptimization(**kw, device="cpu")
    ref.run_optimization(max_iter=2, eps=-1)
    space = DesignSpace(DOMAIN)
    model = GPModel(exact_feval=True, max_iters=0, device="cpu")
    opt = AcquisitionOptimizer(space, "lbfgs", model=model)
    acq = tacq.AcquisitionMPI(model, space, opt)
    bo = ModularBayesianOptimization(model, space, SingleObjective(branin), acq,
                                     tev.Sequential(acq), X_init=ref.X[:5])
    assert bo.modular_optimization and bo.Y is None
    bo.run_optimization(max_iter=2, eps=-1)
    np.testing.assert_array_equal(bo.X, ref.X)
    np.testing.assert_array_equal(bo.Y, ref.Y)


@pytest.mark.parametrize("axis,value", (
    [("acquisition_type", a) for a in ("EI", "MPI", "LCB")]
    + [("initial_design_type", d) for d in ("random", "latin", "latin_mixed", "sobol", "grid",
                                            "hammersley")]
    + [("evaluator_type", e) for e in ("sequential", "random", "thompson_sampling",
                                       "local_penalization")]
    + [("acquisition_optimizer_type", o) for o in ("lbfgs", "lbfgs_host", "DIRECT", "CMA")]))
def test_every_gp_option_is_accepted(axis, value):
    """Each value the reference accepts for ``model_type="GP"`` builds, and one
    ``suggest_next_locations`` through it gives a batch inside the box."""
    kw = _common(anchor_points_samples=60, anchor_points_num=2, **{axis: value})
    if axis == "evaluator_type" and value != "sequential":
        kw["batch_size"] = 2
    theirs = JBO(**kw)
    bo = BayesianOptimization(**kw, device="cpu")
    for name in ("acquisition", "evaluator"):
        assert type(getattr(bo, name)).__name__ == type(getattr(theirs, name)).__name__
    x = bo.suggest_next_locations()
    assert x.shape == (kw.get("batch_size", 1), 2)
    lo, hi = np.array(objectives.branin.bounds).T
    assert np.all((x >= lo) & (x <= hi))


_MCMC = dict(n_samples=3, n_burnin=4, subsample_interval=2, leapfrog_steps=3)


@pytest.mark.parametrize("model_type,acquisition,extra", [
    ("sparseGP", "EI", dict(num_inducing=4)),
    ("GP_MCMC", "EI_MCMC", _MCMC),
    ("GP_MCMC", "MPI_MCMC", _MCMC),
    ("GP_MCMC", "LCB_MCMC", _MCMC),
    ("warpedGP", "EI", {}),
    ("input_warped_GP", "MPI", {}),
    ("RF", "EI", {}),
    ("GP", "ES", {}),
    ("GP", "ES_EPMGP", {}),
])
def test_every_model_and_acquisition_is_accepted(model_type, acquisition, extra):
    """Each surrogate and acquisition the reference accepts beyond the exact
    GP's builds the reference's classes, and one ``suggest_next_locations``
    through it gives a point inside the box."""
    kw = _common(model_type=model_type, acquisition_type=acquisition, anchor_points_samples=60,
                 anchor_points_num=2, **extra)
    theirs = JBO(**kw)
    bo = BayesianOptimization(**kw, device="cpu")
    for name in ("model", "acquisition"):
        assert type(getattr(bo, name)).__name__ == type(getattr(theirs, name)).__name__
    x = bo.suggest_next_locations()
    lo, hi = np.array(objectives.branin.bounds).T
    assert x.shape == (1, 2) and np.all((x >= lo) & (x <= hi))


@pytest.mark.parametrize("kw,error,match", (
    [(dict(mesh=object()), TypeError, "mesh"),
       (dict(pool=object()), NotImplementedError, "pool"),
       (dict(model_type="forest"), InvalidConfigError, "forest"),
       (dict(acquisition_type="UCB"), InvalidConfigError, "UCB"),
       (dict(evaluator_type="greedy", batch_size=2), InvalidConfigError, "greedy"),
       (dict(acquisition_optimizer_type="adam"), ValueError, "adam"),
       (dict(initial_design_type="halton"), ValueError, "halton")]))
def test_what_is_not_ported_raises_by_name(kw, error, match):
    with pytest.raises(error, match=match):
        BayesianOptimization(**_common(**kw), device="cpu")


def test_ask_without_data_or_objective_raises():
    with pytest.raises(InvalidConfigError, match="Initial data"):
        BayesianOptimization(f=None, domain=DOMAIN, device="cpu")


def test_evaluation_time_cost_is_updated_by_the_loop():
    """The initial design's evaluation times reach the cost model at once
    (``_init_design_chooser``), each iteration's after it; the cost model's
    surrogate sits on the loop's device."""
    bo = BayesianOptimization(**_common(cost_withGradients="evaluation_time",
                                        anchor_points_samples=60, anchor_points_num=2),
                              device="cpu")
    assert bo.cost.num_updates == 1 and bo.cost.cost_X.shape == (5, 2)
    assert bo.cost.cost_model.device == torch.device("cpu")
    assert bo.acquisition.has_cost
    bo.run_optimization(max_iter=2, eps=-1)
    assert bo.cost.num_updates == 3 and bo.cost.cost_X.shape == (7, 2)


def test_reports(tmp_path):
    bo = BayesianOptimization(**_common(), device="cpu")
    with pytest.raises(ValueError, match="No iterations"):
        bo.save_models(tmp_path / "none.tsv")
    files = {k: tmp_path / f"{k}.txt" for k in ("report", "evaluations", "models")}
    bo.run_optimization(max_iter=2, eps=-1, report_file=files["report"],
                        evaluations_file=files["evaluations"], models_file=files["models"])
    report = files["report"].read_text()
    for needle in ("Problem dimension: 2", "Number continuous variables: 2",
                   "Cost used: constant", "Model type: GPModel",
                   "Acquisition type: AcquisitionEI", "Evaluator type (batch size): Sequential",
                   f"Value at minimum: {bo.fx_opt}"):
        assert needle in report
    rows = [line.split("\t") for line in files["evaluations"].read_text().splitlines()]
    assert rows[0] == ["Iteration", "Y", "var_1", "var_2"] and len(rows) == 8
    np.testing.assert_allclose([float(r[1]) for r in rows[1:]], bo.Y[:, 0])
    rows = [line.split("\t") for line in files["models"].read_text().splitlines()]
    assert rows[0] == ["Iteration", "variance", "lengthscale", ""] and len(rows) == 4
    X, Y = bo.get_evaluations()
    X[0, 0] = 99.0
    assert bo.X[0, 0] != 99.0 and Y.shape == (7, 1)


def test_regret_run_small():
    """One run of the protocol, cut to 2 iterations and 3 fit steps."""
    r = workload.regret_run("branin", seed=1, iters=2, device="cpu", dtype=torch.float64,
                            max_iters=3, optimize_restarts=2)
    assert r.evaluations == 7 and len(r.regret) == 7 and not r.fit_failed
    assert r.regret == sorted(r.regret, reverse=True) and r.regret[-1] >= 0
    assert r.fx_opt == pytest.approx(r.regret[-1] + objectives.branin.fmin)
    bo = r.bo
    assert type(bo.acquisition).__name__ == "AcquisitionEI" and bo.exact_feval
    assert bo.initial_design_type == "latin" and len(bo.space.space) == 2


def test_func_specs_are_the_protocols():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "benchmarks" / "regret_compare.py"
    spec = importlib.util.spec_from_file_location("regret_compare", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert workload.FUNC_SPECS == mod.FUNC_SPECS


@pytest.mark.parametrize("ours,theirs,overlap", [
    ([0.1, 0.2, 0.3, 0.4], [0.25, 0.3, 0.6, 0.7], True),
    ([0.1, 0.2, 0.3, 0.4], [0.5, 0.6, 0.7, 0.8], False),
    ([0.0, 0.0, 0.0, -1e-7], [5e-7, 5e-7, 6e-7, 7e-7], True)],
    ids=["overlap", "apart", "ties_within_1e-6"])
def test_iqr_overlap_is_the_protocols(ours, theirs, overlap):
    a = regret.final_stats([[1.0, v] for v in ours])
    b = regret.final_stats([[1.0, v] for v in theirs])
    q1, med, q3 = np.percentile(ours, [25, 50, 75])
    assert a == (med, q1, q3)
    assert regret.iqr_overlap(a, b) is overlap is regret.iqr_overlap(b, a)


def test_regret_runner_end_to_end(tmp_path, monkeypatch, capsys):
    """``python -m ...regret --funcs forrester,branin --seeds 2`` on the CPU
    with each run cut short: the curves file, merged across calls, and the
    table beside the stored CPU float64 statistics (never the TPU's)."""
    real = workload.regret_run
    monkeypatch.setattr(workload, "regret_run", lambda name, seed, **kw: real(
        name, seed, iters=1, max_iters=2, optimize_restarts=1, **kw))
    out = tmp_path / "curves.json"
    assert regret.main(["--funcs", "forrester", "--seeds", "2", "--device", "cpu", "--dtype",
                        "float64", "--out", str(out)]) == 0
    assert regret.main(["--funcs", "branin", "--seeds", "2", "--device", "cpu", "--dtype",
                        "float64", "--out", str(out)]) == 0
    stored = json.loads(out.read_text())
    assert set(stored) == {"forrester", "branin"}
    assert len(stored["branin"]["curves"]) == 2 and len(stored["branin"]["curves"][0]) == 6
    text = capsys.readouterr().out
    ref = regret.reference_curves()
    med, q1, q3 = regret.final_stats(ref["branin"])
    assert f"{med:.4f} [{q1:.4f}, {q3:.4f}]" in text and "IQRs overlap" in text
    assert set(ref) == set(workload.FUNC_SPECS)

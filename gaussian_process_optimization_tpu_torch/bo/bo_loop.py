"""The outer Bayesian-optimization loop (twin of
``gaussian_process_optimization_tpu/bo/bo_loop.py``; GPyOpt core/bo.py:21 ``BO``).

Per iteration (bo.py:73-197): refit the surrogate on normalized data, check the
stopping rules (max_iter, max_time, the last two points closer than eps), build
the next batch, evaluate the objective. A fit whose posterior factorization
fails even after one retry ends the run (bo.py:134-137). The loop is host
Python; the surrogate and the acquisition run on the surrogate's device.
``fit_seconds`` is the host-clock time of the last refit; ``seconds`` sums the
run's fit, acquisition and objective phases. ``plot_acquisition`` and
``plot_convergence`` draw the reference's two diagnostics (``utils/plotting``).
"""
from __future__ import annotations

import time

import numpy as np

from ..utils.normalizer import normalize_stats
from .cost import CostModel
from .duplicate_manager import DuplicateManager
from .optimizer import ContextManager


class BO:
    def __init__(self, model, space, objective, acquisition, evaluator, X_init,
                 Y_init=None, cost=None, normalize_Y=True, model_update_interval=1,
                 de_duplication=False):
        self.model = model
        self.space = space
        self.objective = objective
        self.acquisition = acquisition
        self.evaluator = evaluator
        self.X = np.atleast_2d(X_init) if X_init is not None else None
        self.Y = np.atleast_2d(Y_init) if Y_init is not None else None
        self.cost = cost if cost is not None else CostModel(None)
        self.normalize_Y = normalize_Y
        self.model_update_interval = model_update_interval
        self.de_duplication = de_duplication
        self.num_acquisitions = 0
        self.model_parameters_iterations = None
        self.suggested_sample = None
        self.Y_new = None
        self.context = None
        self.fit_seconds = None
        self.seconds = {"fit": 0.0, "acquisition": 0.0, "objective": 0.0}
        self._fit_failed = False

    def suggest_next_locations(self, context=None, pending_X=None, ignored_X=None):
        """Ask (bo.py:55-71): fit on the current (X, Y) and return the next
        batch in objective space."""
        self.model_parameters_iterations = None
        self.num_acquisitions = 0
        self.context = context
        self._update_model()
        return self._compute_next_evaluations(pending_zipped_X=pending_X,
                                              ignored_zipped_X=ignored_X)

    def run_optimization(self, max_iter=0, max_time=np.inf, eps=1e-8, context=None,
                         verbosity=False, save_models_parameters=True, report_file=None,
                         evaluations_file=None, models_file=None):
        """(bo.py:73-197)"""
        self.verbosity = verbosity
        self.context = context
        if self.X is not None and self.Y is None:
            self.Y, cost_values = self.objective.evaluate(self.X)
            if self.cost.cost_type == "evaluation_time":
                self.cost.update_cost_model(self.X, cost_values)
        self.max_iter = max_iter or 0
        self.max_time = max_time
        self.eps = eps
        self.cum_time = 0.0
        self.num_acquisitions = 0
        self.suggested_sample = self.X
        self.Y_new = self.Y
        self._fit_failed = False
        self.seconds = {"fit": 0.0, "acquisition": 0.0, "objective": 0.0}
        while self.max_time > self.cum_time:
            zero_time = time.time()
            self._update_model()
            self.seconds["fit"] += time.time() - zero_time
            if self._fit_failed:
                break
            if save_models_parameters:
                self._save_model_parameter_values()
            if (self.num_acquisitions >= self.max_iter
                    or (len(self.X) > 1 and self._distance_last_evaluations() <= self.eps)):
                break
            t0 = time.time()
            self.suggested_sample = self._compute_next_evaluations()
            self.seconds["acquisition"] += time.time() - t0
            self.X = np.vstack((self.X, self.suggested_sample))
            t0 = time.time()
            self.evaluate_objective()
            self.seconds["objective"] += time.time() - t0
            self.cum_time += time.time() - zero_time
            self.num_acquisitions += 1
            if verbosity:
                print(f"num acquisition: {self.num_acquisitions}, "
                      f"time elapsed: {self.cum_time:.2f}s")
        self._compute_results()
        if report_file is not None:
            self.save_report(report_file)
        if evaluations_file is not None:
            self.save_evaluations(evaluations_file)
        if models_file is not None:
            self.save_models(models_file)

    def evaluate_objective(self):
        """(bo.py:191-197)"""
        self.Y_new, cost_new = self.objective.evaluate(self.suggested_sample)
        self.cost.update_cost_model(self.suggested_sample, cost_new)
        self.Y = np.vstack((self.Y, self.Y_new))

    def _distance_last_evaluations(self):
        """(bo.py:207)"""
        return np.sqrt(np.sum((self.X[-1, :] - self.X[-2, :]) ** 2))

    def _update_model(self):
        """Fit the surrogate on (unzipped X, normalized Y) (bo.py:236-254), with
        one retry when the posterior factorization fails."""
        if self.num_acquisitions % self.model_update_interval != 0:
            return
        t0 = time.perf_counter()
        X_inmodel = self.space.unzip_inputs(self.X)
        Y_inmodel = np.asarray(normalize_stats(self.Y)) if self.normalize_Y else self.Y
        self.model.updateModel(X_inmodel, Y_inmodel, None, None)
        # surrogates without one exact posterior (the MCMC samples, the forest)
        # are not checked, as in the reference
        if not self._posterior_ok():
            self.model.updateModel(X_inmodel, Y_inmodel, None, None)
            if not self._posterior_ok():
                print("Warning: surrogate fit failed (non-PD covariance); stopping.")
                self._fit_failed = True
        self.X_inmodel = X_inmodel
        self.Y_inmodel = Y_inmodel
        self.fit_seconds = time.perf_counter() - t0

    def _posterior_ok(self) -> bool:
        post = getattr(self.model, "posterior", None)
        return post is None or post.ok is None or bool(post.ok)

    def _compute_next_evaluations(self, pending_zipped_X=None, ignored_zipped_X=None):
        """(bo.py:216-235): context, de-duplication, the evaluator's batch, zipped."""
        context_manager = ContextManager(self.space, self.context)
        self.acquisition.optimizer.context_manager = context_manager
        duplicate_manager = None
        if self.de_duplication:
            duplicate_manager = DuplicateManager(
                space=self.space, zipped_X=self.X, pending_zipped_X=pending_zipped_X,
                ignored_zipped_X=ignored_zipped_X)
        suggested = self.evaluator.compute_batch(duplicate_manager=duplicate_manager,
                                                 context_manager=context_manager)
        return self.space.zip_inputs(suggested)

    def _compute_results(self):
        """(bo.py:199-205)"""
        self.Y_best = np.minimum.accumulate(self.Y[:, 0])
        self.x_opt = self.X[np.argmin(self.Y[:, 0]), :]
        self.fx_opt = float(np.min(self.Y[:, 0]))

    def _save_model_parameter_values(self):
        """(bo.py:256)"""
        params = self.model.get_model_parameters()
        if self.model_parameters_iterations is None:
            self.model_parameters_iterations = params
        else:
            self.model_parameters_iterations = np.vstack(
                (self.model_parameters_iterations, params))

    def save_report(self, report_file=None):
        """The run's report as text (bo.py:301-345)."""
        space = self.space
        lines = [
            "----------------------------- Report file -----------------------------------",
            f"Date and time: {time.strftime('%c')}",
            f"Number initial samples: {getattr(self, 'initial_design_numdata', '-')}",
            f"Tolerance: {getattr(self, 'eps', '-')}",
            f"Optimization time: {getattr(self, 'cum_time', '-')} seconds.",
            "",
            "-------------------------------- Problem set up ------------------------------------",
            f"Problem dimension: {space.objective_dimensionality}",
            f"Number continuous variables: {len(space.get_continuous_dims())}",
            f"Number discrete variables: {len(space.get_discrete_dims())}",
            f"Number bandits: {sum(1 for v in space.space_expanded if v.is_bandit)}",
            f"Cost used: {self.cost.cost_type}",
            f"Constraints: {bool(space.constraints)}",
            "",
            "------------------------------ Optimization set up ---------------------------------",
            f"Normalized outputs: {self.normalize_Y}",
            f"Model type: {type(self.model).__name__}",
            f"Acquisition type: {type(self.acquisition).__name__}",
            f"Evaluator type (batch size): {type(self.evaluator).__name__} "
            f"({self.evaluator.batch_size})",
            "",
            "--------------------------------- Summary ------------------------------------------",
            f"Value at minimum: {self.fx_opt}",
            f"Best found minimum location: {self.x_opt}",
        ]
        with open(report_file, "w") as f:
            f.write("\n".join(lines) + "\n")

    @staticmethod
    def _write_tsv(path, header, rows):
        with open(path, "w") as f:
            f.write("\t".join(header) + "\n")
            for row in rows:
                f.write("\t".join(str(v) for v in row) + "\n")

    def save_evaluations(self, evaluations_file=None):
        """Iteration, Y, X as tab-separated values (bo.py:347-365)."""
        iterations = np.arange(1, self.Y.shape[0] + 1)[:, None]
        header = ["Iteration", "Y"] + [f"var_{i + 1}" for i in range(self.X.shape[1])]
        self._write_tsv(evaluations_file, header, np.hstack([iterations, self.Y, self.X]))

    def save_models(self, models_file):
        """The hyperparameters of every iteration as tab-separated values
        (bo.py:367-392)."""
        if self.model_parameters_iterations is None:
            raise ValueError("No iterations have been carried out yet; cannot save models")
        params = self.model_parameters_iterations
        iterations = np.arange(1, params.shape[0] + 1)[:, None]
        header = ["Iteration"] + list(self.model.get_model_parameters_names())
        self._write_tsv(models_file, header, np.hstack([iterations, params]))

    # ------------------------------------------------------------------ plots
    def plot_acquisition(self, filename=None, label_x=None, label_y=None):
        """The surrogate and the acquisition over a 1-D or 2-D space, with the
        next suggestion (bo.py plot_acquisition). The padded rows of the
        surrogate's buffers are left out."""
        from ..utils.plotting import plot_acquisition
        from ..utils.plotting_library import _model_xy

        suggested = self.suggest_next_locations()
        Xd, Yd = _model_xy(self.model.model)
        return plot_acquisition(self.acquisition.space.get_bounds(), Xd.shape[1], self.model,
                                Xd, Yd, self.acquisition.acquisition_function, suggested,
                                filename=filename, label_x=label_x, label_y=label_y)

    def plot_convergence(self, filename=None):
        """Distances between consecutive x's and the best y so far (bo.py
        plot_convergence)."""
        from ..utils.plotting import plot_convergence

        return plot_convergence(self.X, self.Y_best, filename)

    def get_evaluations(self):
        return self.X.copy(), self.Y.copy()

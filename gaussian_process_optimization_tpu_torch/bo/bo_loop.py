"""The outer Bayesian-optimization loop (twin of
``gaussian_process_optimization_tpu/bo/bo_loop.py``; GPyOpt core/bo.py:21 ``BO``).

Per iteration (bo.py:73-197): refit the surrogate on normalized data, check the
stopping rules (max_iter, max_time, the last two points closer than eps), build
the next batch, evaluate the objective. A fit whose posterior factorization
fails even after one retry ends the run (bo.py:134-137). The loop is host
Python; the surrogate and the acquisition run on the surrogate's device.
Reports, plots and the saved per-iteration parameters are not ported.
``fit_seconds`` is the host-clock time of the last refit.
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
        self.context = None
        self.fit_seconds = None
        self._fit_failed = False

    def suggest_next_locations(self, context=None, pending_X=None, ignored_X=None):
        """Ask (bo.py:55-71): fit on the current (X, Y) and return the next
        batch in objective space."""
        self.num_acquisitions = 0
        self.context = context
        self._update_model()
        return self._compute_next_evaluations(pending_zipped_X=pending_X,
                                              ignored_zipped_X=ignored_X)

    def run_optimization(self, max_iter=0, max_time=np.inf, eps=1e-8, context=None,
                         verbosity=False):
        """(bo.py:73-197)"""
        self.context = context
        if self.X is not None and self.Y is None:
            self.Y, _ = self.objective.evaluate(self.X)
        max_iter = max_iter or 0
        cum_time = 0.0
        self.num_acquisitions = 0
        self._fit_failed = False
        while max_time > cum_time:
            zero_time = time.time()
            self._update_model()
            if self._fit_failed:
                break
            if (self.num_acquisitions >= max_iter
                    or (len(self.X) > 1 and self._distance_last_evaluations() <= eps)):
                break
            suggested = self._compute_next_evaluations()
            self.X = np.vstack((self.X, suggested))
            Y_new, cost_new = self.objective.evaluate(suggested)
            self.cost.update_cost_model(suggested, cost_new)
            self.Y = np.vstack((self.Y, Y_new))
            cum_time += time.time() - zero_time
            self.num_acquisitions += 1
            if verbosity:
                print(f"num acquisition: {self.num_acquisitions}, "
                      f"time elapsed: {cum_time:.2f}s")
        self.Y_best = np.minimum.accumulate(self.Y[:, 0])
        self.x_opt = self.X[np.argmin(self.Y[:, 0]), :]
        self.fx_opt = float(np.min(self.Y[:, 0]))

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
        if not bool(self.model.posterior.ok):
            self.model.updateModel(X_inmodel, Y_inmodel, None, None)
            if not bool(self.model.posterior.ok):
                print("Warning: surrogate fit failed (non-PD covariance); stopping.")
                self._fit_failed = True
        self.fit_seconds = time.perf_counter() - t0

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

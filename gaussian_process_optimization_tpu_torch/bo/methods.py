"""User API (twin of ``gaussian_process_optimization_tpu/bo/methods.py``; GPyOpt
methods/bayesian_optimization.py:24 ``BayesianOptimization`` and
util/arguments_manager.py:9 ``ArgumentsManager``).

Ported choices: model 'GP' (with the reference author's ``Gower`` kwarg),
acquisition 'EI', evaluators 'sequential' and 'local_penalization', the 'lbfgs'
acquisition optimizer, the 'random' initial design. ``device`` and ``dtype``
kwargs place the surrogate (on the card in float64 by default; ``device="cpu"``
for the CPU). A kwarg the port does not read raises, so a setting is never
silently dropped.
"""
from __future__ import annotations

import numpy as np

from ..models.bo_models import GPModel
from .acquisitions import AcquisitionEI, AcquisitionLP
from .bo_loop import BO
from .cost import CostModel
from .designs import initial_design
from .evaluators import LocalPenalization, Sequential
from .objective import SingleObjective
from .optimizer import AcquisitionOptimizer
from .space import DesignSpace
from .variables import InvalidConfigError

_KWARGS = {"kernel", "ARD", "Gower", "noise_var", "max_iters", "optimize_restarts",
           "device", "dtype"}


class ArgumentsManager:
    """kwargs -> components (util/arguments_manager.py:9)."""

    def __init__(self, kwargs):
        unknown = set(kwargs) - _KWARGS
        if unknown:
            raise NotImplementedError(f"options not ported: {sorted(unknown)}")
        self.kwargs = kwargs

    def model_creator(self, model_type, exact_feval, space, seed):
        """(arguments_manager.py:80)"""
        if model_type != "GP":
            raise NotImplementedError(f"model type {model_type!r} is not ported")
        kw = self.kwargs
        kw_model = {k: kw[k] for k in ("device", "dtype") if k in kw}
        return GPModel(kernel=kw.get("kernel"), noise_var=kw.get("noise_var"),
                       exact_feval=exact_feval, max_iters=kw.get("max_iters", 1000),
                       optimize_restarts=kw.get("optimize_restarts", 5),
                       ARD=kw.get("ARD", False), Gower=kw.get("Gower", False), space=space,
                       seed=seed, **kw_model)

    def acquisition_creator(self, acquisition_type, model, space, acquisition_optimizer):
        """(arguments_manager.py:42)"""
        if (acquisition_type or "EI") != "EI":
            raise NotImplementedError(f"acquisition {acquisition_type!r} is not ported")
        return AcquisitionEI(model, space, acquisition_optimizer)

    def evaluator_creator(self, evaluator_type, acquisition, batch_size, model, space,
                          acquisition_optimizer):
        """(arguments_manager.py:17)"""
        evaluator_type = evaluator_type or "sequential"
        if batch_size == 1 or evaluator_type == "sequential":
            return Sequential(acquisition)
        if evaluator_type == "local_penalization":
            return LocalPenalization(
                AcquisitionLP(model, space, acquisition_optimizer, acquisition), batch_size)
        raise NotImplementedError(f"evaluator {evaluator_type!r} is not ported")


class BayesianOptimization(BO):
    """One-stop BO entry point (methods/bayesian_optimization.py:24). ``f`` may be
    None for ask-tell use: pass X and Y and call ``suggest_next_locations``."""

    def __init__(self, f, domain=None, constraints=None, cost_withGradients=None,
                 model_type="GP", X=None, Y=None, initial_design_numdata=5,
                 initial_design_type="random", acquisition_type="EI", normalize_Y=True,
                 exact_feval=False, acquisition_optimizer_type="lbfgs",
                 model_update_interval=1, evaluator_type="sequential", batch_size=1,
                 num_cores=1, maximize=False, de_duplication=False, seed=None, **kwargs):
        if acquisition_optimizer_type != "lbfgs":
            raise NotImplementedError(
                f"acquisition optimizer {acquisition_optimizer_type!r} is not ported")
        args = ArgumentsManager(kwargs)
        self.space = DesignSpace(domain, constraints)
        self.maximize = maximize
        self.f = f if f is None or not maximize else (lambda x: -np.asarray(f(x)))
        self.batch_size = batch_size
        objective = None
        if self.f is not None:
            objective = SingleObjective(self.f, num_cores)
        cost = CostModel(cost_withGradients)
        if X is None or Y is None:
            if objective is None:
                # bayesian_optimization.py:187: nothing to evaluate the design with
                raise InvalidConfigError("Initial data for both X and Y is required when "
                                         "objective function is not provided")
            if X is None:
                X = initial_design(initial_design_type, self.space, initial_design_numdata,
                                   seed=seed)
            Y, _ = objective.evaluate(X)
        # the surrogate's restart generator is seeded as the reference seeds its
        # PRNG key (GPModel's default seed 0: the ArgumentsManager passes none)
        model = args.model_creator(model_type, exact_feval, self.space, seed=0)
        optimizer = AcquisitionOptimizer(self.space)
        acquisition = args.acquisition_creator(acquisition_type, model, self.space, optimizer)
        evaluator = args.evaluator_creator(evaluator_type, acquisition, batch_size, model,
                                           self.space, optimizer)
        super().__init__(model=model, space=self.space, objective=objective,
                         acquisition=evaluator.acquisition, evaluator=evaluator, X_init=X,
                         Y_init=Y, cost=cost, normalize_Y=normalize_Y,
                         model_update_interval=model_update_interval,
                         de_duplication=de_duplication)

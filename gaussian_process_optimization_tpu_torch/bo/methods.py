"""User API (twin of ``gaussian_process_optimization_tpu/bo/methods.py``; GPyOpt
methods/bayesian_optimization.py:24 ``BayesianOptimization``,
modular_bayesian_optimization.py:6 ``ModularBayesianOptimization`` and
util/arguments_manager.py:9 ``ArgumentsManager``).

Ported choices for ``model_type="GP"`` (with the reference author's ``Gower``
kwarg): acquisitions EI, MPI and LCB; evaluators sequential, random,
thompson_sampling and local_penalization; acquisition optimizers lbfgs,
lbfgs_host, DIRECT and CMA; all six initial designs; every cost
(None, 'evaluation_time', a callable). The other model types, the ``_MCMC``
acquisitions and entropy search raise ``NotImplementedError`` by name.
``device`` and ``dtype`` kwargs place the surrogate (on the card in float64 by
default; ``device="cpu"`` for the CPU); ``mean_function`` and ``priors`` go to
the surrogate. A kwarg the port does not read raises, so a setting is never
silently dropped.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..models.bo_models import GPModel
from .acquisitions import AcquisitionEI, AcquisitionLCB, AcquisitionLP, AcquisitionMPI
from .bo_loop import BO
from .cost import CostModel
from .designs import initial_design
from .evaluators import LocalPenalization, RandomBatch, Sequential, ThompsonBatch
from .objective import SingleObjective
from .optimizer import AcquisitionOptimizer
from .space import DesignSpace
from .variables import InvalidConfigError

_KWARGS = {
    # the surrogate (arguments_manager.py:80)
    "kernel", "ARD", "Gower", "noise_var", "optimizer", "max_iters", "optimize_restarts",
    "verbosity_model", "mean_function", "priors", "device", "dtype",
    # the acquisition (:42) and LP's transform
    "acquisition_jitter", "acquisition_weight", "transform",
    # the acquisition optimizer's anchors (bayesian_optimization.py:144-158)
    "anchor_points_design", "anchor_points_samples", "anchor_points_num",
    "objective_name",
}
_OTHER_MODELS = ("sparseGP", "GP_MCMC", "warpedGP", "input_warped_GP", "RF")
_OTHER_ACQUISITIONS = ("EI_MCMC", "MPI_MCMC", "LCB_MCMC", "ES", "ES_EPMGP")


class ArgumentsManager:
    """kwargs -> components (util/arguments_manager.py:9)."""

    def __init__(self, kwargs):
        unknown = set(kwargs) - _KWARGS
        if unknown:
            raise NotImplementedError(f"options not ported: {sorted(unknown)}")
        self.kwargs = kwargs

    def model_creator(self, model_type, exact_feval, space, seed=0):
        """(arguments_manager.py:80)"""
        if model_type in _OTHER_MODELS:
            raise NotImplementedError(f"model type {model_type!r} is not ported")
        if model_type != "GP":
            raise InvalidConfigError(f"unknown model type {model_type!r}")
        kw = self.kwargs
        kw_model = {k: kw[k] for k in ("device", "dtype", "mean_function", "priors")
                    if k in kw}
        return GPModel(kernel=kw.get("kernel"), noise_var=kw.get("noise_var"),
                       exact_feval=exact_feval, optimizer=kw.get("optimizer", "lbfgs"),
                       max_iters=kw.get("max_iters", 1000),
                       optimize_restarts=kw.get("optimize_restarts", 5),
                       verbose=kw.get("verbosity_model", False),
                       ARD=kw.get("ARD", False), Gower=kw.get("Gower", False), space=space,
                       seed=seed, **kw_model)

    def acquisition_creator(self, acquisition_type, model, space, acquisition_optimizer,
                            cost_withGradients=None):
        """(arguments_manager.py:42): EI / MPI with jitter 0.01, LCB with weight 2."""
        acquisition_type = acquisition_type or "EI"
        jitter = self.kwargs.get("acquisition_jitter", 0.01)
        weight = self.kwargs.get("acquisition_weight", 2)
        if acquisition_type == "EI":
            return AcquisitionEI(model, space, acquisition_optimizer, cost_withGradients, jitter)
        if acquisition_type == "MPI":
            return AcquisitionMPI(model, space, acquisition_optimizer, cost_withGradients,
                                  jitter)
        if acquisition_type == "LCB":
            return AcquisitionLCB(model, space, acquisition_optimizer, None, weight)
        if acquisition_type in _OTHER_ACQUISITIONS:
            raise NotImplementedError(f"acquisition {acquisition_type!r} is not ported")
        raise InvalidConfigError(f"unknown acquisition type {acquisition_type!r}")

    def evaluator_creator(self, evaluator_type, acquisition, batch_size, model, space,
                          acquisition_optimizer):
        """(arguments_manager.py:17)"""
        evaluator_type = evaluator_type or "sequential"
        if batch_size == 1 or evaluator_type == "sequential":
            return Sequential(acquisition)
        if evaluator_type in ("random", "random_batch"):
            return RandomBatch(acquisition, batch_size)
        if evaluator_type == "thompson_sampling":
            return ThompsonBatch(acquisition, batch_size)
        if evaluator_type == "local_penalization":
            if not isinstance(acquisition, AcquisitionLP):
                acquisition = AcquisitionLP(model, space, acquisition_optimizer, acquisition,
                                            transform=self.kwargs.get("transform", "none"))
            return LocalPenalization(acquisition, batch_size)
        raise InvalidConfigError(f"unknown evaluator type {evaluator_type!r}")


class BayesianOptimization(BO):
    """One-stop BO entry point (methods/bayesian_optimization.py:24). ``f`` may be
    None for ask-tell use: pass X and Y and call ``suggest_next_locations``."""

    def __init__(self, f, domain=None, constraints=None, cost_withGradients=None,
                 model_type="GP", X=None, Y=None, initial_design_numdata=5,
                 initial_design_type="random", acquisition_type="EI", normalize_Y=True,
                 exact_feval=False, acquisition_optimizer_type="lbfgs",
                 model_update_interval=1, evaluator_type="sequential", batch_size=1,
                 num_cores=1, verbosity=False, verbosity_model=False, maximize=False,
                 de_duplication=False, seed=None, **kwargs):
        self.initial_iter = True
        self.verbosity = verbosity
        self.verbosity_model = verbosity_model
        self.modular_optimization = False
        self.kwargs = kwargs
        args = ArgumentsManager(dict(kwargs, verbosity_model=verbosity_model))
        device = resolve_device(kwargs.get("device"))
        dtype = kwargs.get("dtype", torch.float64)

        self.constraints = constraints
        self.space = DesignSpace(domain, constraints)
        self.maximize = maximize
        self.f = f if f is None or not maximize else (lambda x: -np.asarray(f(x)))
        self.objective_name = kwargs.get("objective_name", "no_name")
        self.batch_size = batch_size
        self.num_cores = num_cores
        self.objective = None
        if self.f is not None:
            self.objective = SingleObjective(self.f, num_cores, self.objective_name)
        self.cost = CostModel(cost_withGradients, device=device, dtype=dtype)

        self.initial_design_numdata = initial_design_numdata
        self.initial_design_type = initial_design_type
        X, Y = self._init_design_chooser(X, Y, seed)

        # the surrogate's restart generator is seeded as the reference seeds its
        # PRNG key (GPModel's default seed 0: the ArgumentsManager passes none)
        self.model_type = model_type
        self.exact_feval = exact_feval
        model = args.model_creator(model_type, exact_feval, self.space, seed=0)
        self.acquisition_optimizer_type = acquisition_optimizer_type
        self.acquisition_optimizer = AcquisitionOptimizer(
            self.space, acquisition_optimizer_type, model=model,
            design_type=kwargs.get("anchor_points_design", "random"),
            num_samples=kwargs.get("anchor_points_samples", 1000),
            num_anchor=kwargs.get("anchor_points_num", 5))
        self.acquisition_type = acquisition_type
        acquisition = args.acquisition_creator(
            acquisition_type, model, self.space, self.acquisition_optimizer,
            self.cost.cost_withGradients)
        self.evaluator_type = evaluator_type
        evaluator = args.evaluator_creator(evaluator_type, acquisition, batch_size, model,
                                           self.space, self.acquisition_optimizer)
        super().__init__(model=model, space=self.space, objective=self.objective,
                         acquisition=evaluator.acquisition, evaluator=evaluator, X_init=X,
                         Y_init=Y, cost=self.cost, normalize_Y=normalize_Y,
                         model_update_interval=model_update_interval,
                         de_duplication=de_duplication)

    def _init_design_chooser(self, X, Y, seed=None):
        """Sample and evaluate the initial design unless X and Y are given
        (:181-196); the initial evaluations' times go to an 'evaluation_time'
        cost model at once."""
        if self.f is None and (X is None or Y is None):
            # bayesian_optimization.py:187: nothing to evaluate the design with
            raise InvalidConfigError("Initial data for both X and Y is required when "
                                     "objective function is not provided")
        cost_values = None
        if X is None:
            X = initial_design(self.initial_design_type, self.space,
                               self.initial_design_numdata, seed=seed)
            Y, cost_values = self.objective.evaluate(X)
        elif Y is None:
            Y, cost_values = self.objective.evaluate(X)
        if cost_values is not None and self.cost.cost_type == "evaluation_time":
            self.cost.update_cost_model(X, cost_values)
        return X, Y


class ModularBayesianOptimization(BO):
    """Bring-your-own-components BO (methods/modular_bayesian_optimization.py:6)."""

    def __init__(self, model, space, objective, acquisition, evaluator, X_init,
                 Y_init=None, cost=None, normalize_Y=True, model_update_interval=1,
                 de_duplication=False):
        self.initial_iter = True
        self.modular_optimization = True
        super().__init__(model=model, space=space, objective=objective,
                         acquisition=acquisition, evaluator=evaluator, X_init=X_init,
                         Y_init=Y_init, cost=cost, normalize_Y=normalize_Y,
                         model_update_interval=model_update_interval,
                         de_duplication=de_duplication)

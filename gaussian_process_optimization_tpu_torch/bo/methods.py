"""User API (twin of ``gaussian_process_optimization_tpu/bo/methods.py``; GPyOpt
methods/bayesian_optimization.py:24 ``BayesianOptimization``,
modular_bayesian_optimization.py:6 ``ModularBayesianOptimization`` and
util/arguments_manager.py:9 ``ArgumentsManager``).

Every choice of the reference: the model types GP (with the reference author's
``Gower`` kwarg), sparseGP, GP_MCMC, warpedGP, input_warped_GP and RF; the
acquisitions EI, MPI, LCB, their ``_MCMC`` versions, ES and ES_EPMGP; evaluators
sequential, random, thompson_sampling and local_penalization; acquisition
optimizers lbfgs, lbfgs_host, DIRECT and CMA; all six initial designs; every
cost (None, 'evaluation_time', a callable).
``device`` and ``dtype`` kwargs place the surrogate (on the card in float32 by
default; ``device="cpu"`` for the CPU, in float64 unless ``dtype`` says otherwise); ``mean_function`` and ``priors`` go to
the surrogate. ``mesh`` (a ``parallel/sharded.Mesh``) shards the GP's fit
restarts and the acquisition's sweep and anchor polish over its devices. A
kwarg the port does not read raises, so a setting is never silently dropped.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..models.bo_models import GPModel
from ..models.mcmc_bo_model import GPModel_MCMC
from ..models.rf_model import RFModel
from ..models.sparse_bo_model import SparseGPModel
from ..models.warped_bo_model import InputWarpedGPModel, WarpedGPModel
from ..parallel import sharded
from .acquisitions import AcquisitionEI, AcquisitionLCB, AcquisitionLP, AcquisitionMPI
from .acquisitions_mcmc import AcquisitionEI_MCMC, AcquisitionLCB_MCMC, AcquisitionMPI_MCMC
from .entropy_search import AcquisitionEntropySearch, AcquisitionEntropySearchEPMGP
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
    "verbosity_model", "mean_function", "priors", "device", "dtype", "mesh",
    # sparseGP's and GP_MCMC's (arguments_manager.py:80-137)
    "num_inducing", "n_samples", "n_burnin", "subsample_interval", "step_size",
    "leapfrog_steps",
    # the acquisition (:42) and LP's transform
    "acquisition_jitter", "acquisition_weight", "transform",
    # the acquisition optimizer's anchors (bayesian_optimization.py:144-158)
    "anchor_points_design", "anchor_points_samples", "anchor_points_num",
    "objective_name",
}


class ArgumentsManager:
    """kwargs -> components (util/arguments_manager.py:9)."""

    def __init__(self, kwargs):
        unknown = set(kwargs) - _KWARGS
        if unknown:
            raise NotImplementedError(f"options not ported: {sorted(unknown)}")
        sharded.check_mesh(kwargs.get("mesh"))
        self.kwargs = kwargs

    def model_creator(self, model_type, exact_feval, space, seed=0):
        """(arguments_manager.py:80): 'GP' | 'sparseGP' | 'GP_MCMC' | 'warpedGP' |
        'input_warped_GP' | 'RF'. ``device`` and ``dtype`` go to every model but
        the host-only forest."""
        kw = self.kwargs
        place = {k: kw[k] for k in ("device", "dtype") if k in kw}
        common = dict(kernel=kw.get("kernel"), noise_var=kw.get("noise_var"),
                      exact_feval=exact_feval, verbose=kw.get("verbosity_model", False),
                      seed=seed, **place)
        fit = dict(optimizer=kw.get("optimizer", "lbfgs"), max_iters=kw.get("max_iters", 1000),
                   optimize_restarts=kw.get("optimize_restarts", 5), ARD=kw.get("ARD", False))
        if model_type == "GP":
            extra = {k: kw[k] for k in ("mean_function", "priors", "mesh") if k in kw}
            return GPModel(Gower=kw.get("Gower", False), space=space, **common, **fit, **extra)
        if model_type == "sparseGP":
            return SparseGPModel(num_inducing=kw.get("num_inducing", 10), **common, **fit)
        if model_type == "GP_MCMC":
            return GPModel_MCMC(n_samples=kw.get("n_samples", 10),
                                n_burnin=kw.get("n_burnin", 100),
                                subsample_interval=kw.get("subsample_interval", 10),
                                step_size=kw.get("step_size", 1e-1),
                                leapfrog_steps=kw.get("leapfrog_steps", 20), **common)
        if model_type == "warpedGP":
            return WarpedGPModel(**common, **fit)
        if model_type == "input_warped_GP":
            return InputWarpedGPModel(space, **common, **fit)
        if model_type == "RF":
            return RFModel(verbose=common["verbose"])
        raise InvalidConfigError(f"unknown model type {model_type!r}")

    def acquisition_creator(self, acquisition_type, model, space, acquisition_optimizer,
                            cost_withGradients=None):
        """(arguments_manager.py:42): EI / MPI (and their ``_MCMC`` versions) with
        jitter 0.01, LCB (and LCB_MCMC) with weight 2, ES and ES_EPMGP."""
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
        if acquisition_type == "EI_MCMC":
            return AcquisitionEI_MCMC(model, space, acquisition_optimizer, cost_withGradients,
                                      jitter)
        if acquisition_type == "MPI_MCMC":
            return AcquisitionMPI_MCMC(model, space, acquisition_optimizer,
                                       cost_withGradients, jitter)
        if acquisition_type == "LCB_MCMC":
            return AcquisitionLCB_MCMC(model, space, acquisition_optimizer, None, weight)
        if acquisition_type == "ES":
            return AcquisitionEntropySearch(model, space, acquisition_optimizer,
                                            cost_withGradients=cost_withGradients)
        if acquisition_type == "ES_EPMGP":
            return AcquisitionEntropySearchEPMGP(model, space, acquisition_optimizer,
                                                 cost_withGradients=cost_withGradients)
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
        dtype = resolve_dtype(kwargs.get("dtype"), device)

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
            num_anchor=kwargs.get("anchor_points_num", 5), mesh=kwargs.get("mesh"))
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

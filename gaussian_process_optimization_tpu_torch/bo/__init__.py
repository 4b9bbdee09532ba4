"""Bayesian-optimization stack (twin of ``gaussian_process_optimization_tpu/bo``)."""
from . import objectives
from .acquisitions import (
    AcquisitionBase,
    AcquisitionEI,
    AcquisitionLCB,
    AcquisitionLP,
    AcquisitionMPI,
)
from .bo_loop import BO
from .cost import CostModel
from .designs import initial_design
from .duplicate_manager import DuplicateManager
from .evaluators import LocalPenalization, RandomBatch, Sequential, ThompsonBatch
from .methods import ArgumentsManager, BayesianOptimization, ModularBayesianOptimization
from .objective import SingleObjective
from .optimizer import AcquisitionOptimizer, ContextManager
from .space import DesignSpace, bounds_to_space
from .variables import (
    BanditVariable,
    CategoricalVariable,
    ContinuousVariable,
    DiscreteVariable,
    FullyExploredOptimizationDomainError,
    InvalidConfigError,
    InvalidVariableNameError,
)

__all__ = [
    "AcquisitionBase", "AcquisitionEI", "AcquisitionLCB", "AcquisitionLP",
    "AcquisitionMPI", "BO", "CostModel", "initial_design", "DuplicateManager",
    "LocalPenalization", "RandomBatch", "Sequential", "ThompsonBatch",
    "ArgumentsManager", "BayesianOptimization", "ModularBayesianOptimization",
    "SingleObjective", "AcquisitionOptimizer", "ContextManager", "DesignSpace",
    "bounds_to_space", "BanditVariable", "CategoricalVariable", "ContinuousVariable",
    "DiscreteVariable", "FullyExploredOptimizationDomainError", "InvalidConfigError",
    "InvalidVariableNameError", "objectives",
]

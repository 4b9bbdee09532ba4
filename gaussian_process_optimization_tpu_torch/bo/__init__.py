"""Bayesian-optimization stack (twin of ``gaussian_process_optimization_tpu/bo``)."""
from . import objectives
from .methods import BayesianOptimization, ModularBayesianOptimization
from .space import DesignSpace, bounds_to_space

__all__ = ["BayesianOptimization", "ModularBayesianOptimization", "DesignSpace",
           "bounds_to_space", "objectives"]

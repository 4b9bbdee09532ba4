"""Bayesian-optimization stack (twin of ``gaussian_process_optimization_tpu/bo``)."""
from .methods import BayesianOptimization
from .space import DesignSpace, bounds_to_space

__all__ = ["BayesianOptimization", "DesignSpace", "bounds_to_space"]

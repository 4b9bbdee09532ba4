"""The kernel zoo (twin of ``gaussian_process_optimization_tpu/kernels``): every
export of the reference's ``__all__``, plus ``GridRBF``."""
import dataclasses as _dataclasses

from .base import Add, Kernel, Prod
from .gower import Gower
from .integral import Integral, IntegralLimits, MultidimensionalIntegralLimits
from .lfm import EQ_ODE1, EQ_ODE2
from .linear import Linear, LinearFull
from .misc import (BasisFuncKernel, ChangePointBasisFuncKernel, DomainKernel, Hierarchical,
                   IndependentOutputs, LinearSlopeBasisFuncKernel, LogisticBasisFuncKernel,
                   PolynomialBasisFuncKernel, Symmetric, TruncLinear, TruncLinear_inf,
                   TruncLinearInf)
from .ode import ODE_UY, ODE_UYC, ODE_st, ODE_t
from .other import MLP, Brownian, Coregionalize, Poly, Spline, StandardPeriodic
from .periodic_rkhs import PeriodicExponential, PeriodicMatern32, PeriodicMatern52
from .split import DEtime, MultioutputKern, SplitKern
from .static import Bias, Fixed, White, WhiteHeteroscedastic
from .stationary import (OU, RBF, Cosine, Exponential, ExpQuad, Matern32, Matern52, RatQuad,
                         Sinc, Stationary, safe_sqrt, sq_dist)
from .symbolic import SymbolicKernel

__all__ = [
    "Add", "Kernel", "Prod", "Gower", "Linear", "MLP", "Brownian", "Coregionalize",
    "Poly", "Spline", "StandardPeriodic", "Bias", "Fixed", "White",
    "WhiteHeteroscedastic", "OU", "RBF", "Cosine",
    "Exponential", "ExpQuad", "Matern32", "Matern52", "RatQuad", "Sinc", "Stationary",
    "safe_sqrt", "sq_dist", "Integral", "PeriodicExponential", "PeriodicMatern32",
    "PeriodicMatern52", "GridRBF", "SplitKern", "DEtime", "MultioutputKern",
    "EQ_ODE1", "EQ_ODE2", "TruncLinear", "TruncLinearInf", "TruncLinear_inf",
    "LinearFull", "Hierarchical", "Symmetric", "BasisFuncKernel",
    "PolynomialBasisFuncKernel", "LinearSlopeBasisFuncKernel",
    "ChangePointBasisFuncKernel", "DomainKernel", "LogisticBasisFuncKernel",
    "IndependentOutputs", "IntegralLimits", "MultidimensionalIntegralLimits",
    "ODE_UY", "ODE_UYC", "ODE_t", "ODE_st", "SymbolicKernel",
]


@_dataclasses.dataclass(frozen=True)
class GridRBF(RBF):
    """RBF for Kronecker / grid inference (GPy grid_kerns.py GridRBF). The
    reference's subclass only adds per-factor derivative helpers for its grid
    inference; ``models/gp_grid.py`` differentiates through the per-axis K
    builds, so the grid kernel is the plain RBF."""

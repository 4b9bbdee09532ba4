"""Models (twin of ``gaussian_process_optimization_tpu/models``). Importing the
package attaches the ``m.plot()`` family to the model and kernel classes, as
GPy's ``plotting/__init__.py inject_plotting`` (:41) does."""
from .bo_models import BOModel, GPModel
from .gp import GPRegression, Posterior
from .sparse import SparseGPRegression, SparsePosterior
from .svgp import SVGP, fit_svgp
from .fit import Fitter
from . import fit  # noqa: F401  (the submodule, not the fit() function)
from .mean_functions import (
    Additive,
    Compound,
    Constant,
    Identity,
    KernelMapping,
    LinearMapping,
    Mapping,
    MLPMapping,
    PiecewiseLinear,
)

__all__ = [
    "BOModel", "GPModel", "GPRegression", "Posterior", "SparseGPRegression",
    "SparsePosterior", "SVGP", "fit_svgp", "Fitter", "fit", "Additive", "Compound",
    "Constant", "Identity", "KernelMapping", "LinearMapping", "Mapping",
    "MLPMapping", "PiecewiseLinear",
]

from ..utils.plotting_library import inject_plotting as _inject_plotting

_inject_plotting()

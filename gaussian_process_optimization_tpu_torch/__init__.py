"""PyTorch and CUDA port of ``gaussian_process_optimization_tpu``.

The JAX package beside this one is the reference: module paths mirror it, and
each ported function is tested against its JAX counterpart. Importing this
package imports ``torch`` and never ``jax``; CUDA kernels are built at first
use (``ops/_build.py``).
"""

__version__ = "0.1.0"

# the Config instance, as in the reference; importing the submodule pins the
# float32 matmul precision
from .config import config  # noqa: F401


def __getattr__(name):
    # lazy top-level conveniences: gpo.GPRegression, gpo.BayesianOptimization, ...
    # (import_module, not ``from . import``: the latter asks this hook for the
    # submodule first and would recurse on ``kernels``)
    from importlib import import_module

    if name in ("GPRegression", "SparseGPRegression", "SVGP", "Fitter"):
        return getattr(import_module(f"{__name__}.models"), name)
    if name in ("BayesianOptimization", "ModularBayesianOptimization", "DesignSpace",
                "bounds_to_space", "initial_design"):
        return getattr(import_module(f"{__name__}.bo"), name)
    if name == "kernels":
        return import_module(f"{__name__}.kernels")
    raise AttributeError(name)

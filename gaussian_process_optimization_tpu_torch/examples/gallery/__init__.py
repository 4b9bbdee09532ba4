"""Examples gallery (twin of the repository's ``examples/gallery``): the demos of
GPy's examples (regression, classification, dimensionality_reduction,
non_gaussian, state_space) on this package, with the reference's synthetic
data. Every demo takes the reference's arguments plus ``device`` (None: the
card) and ``dtype`` (None: float32 on the card, float64 on the CPU).
"""
from . import (  # noqa: F401
    classification,
    dimensionality_reduction,
    non_gaussian,
    regression,
    state_space,
)

MODULES = [regression, classification, dimensionality_reduction, non_gaussian,
           state_space]

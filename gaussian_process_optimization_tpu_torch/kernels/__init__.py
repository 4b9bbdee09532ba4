from .base import Kernel
from .gower import Gower
from .stationary import (OU, RBF, Cosine, Exponential, ExpQuad, Matern32, Matern52,
                         RatQuad, Stationary)

__all__ = ["Kernel", "Gower", "Stationary", "RBF", "ExpQuad", "Exponential", "OU", "Matern32",
           "Matern52", "Cosine", "RatQuad"]

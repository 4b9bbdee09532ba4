from .base import Add, Kernel, Prod
from .gower import Gower
from .stationary import (OU, RBF, Cosine, Exponential, ExpQuad, Matern32, Matern52,
                         RatQuad, Sinc, Stationary)

__all__ = ["Kernel", "Add", "Prod", "Gower", "Stationary", "RBF", "ExpQuad", "Exponential",
           "OU", "Matern32", "Matern52", "Cosine", "Sinc", "RatQuad"]

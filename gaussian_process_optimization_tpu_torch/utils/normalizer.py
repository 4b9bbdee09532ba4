"""Y standardization (twin of ``gaussian_process_optimization_tpu/utils/normalizer.py``,
GPy util/normalizer.py:9 ``Standardize``, and GPyOpt's 'stats' normalization
of the BO loop, util/general.py:203-217)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Standardize:
    mean: torch.Tensor = None
    std: torch.Tensor = None

    @classmethod
    def fit(cls, Y: torch.Tensor) -> "Standardize":
        mean = torch.mean(Y, dim=0)
        std = torch.std(Y, dim=0, unbiased=False)  # jnp.std is the population std
        std = torch.where(std <= 0, torch.ones_like(std), std)
        return cls(mean=mean, std=std)

    def normalize(self, Y):
        return (Y - self.mean) / self.std

    def inverse_mean(self, mu):
        return mu * self.std + self.mean

    def inverse_variance(self, var):
        return var * torch.square(self.std)


def normalize_stats(Y):
    """GPyOpt 'stats' normalization (util/general.py:211), host numpy:
    (Y - mean) / std, or only Y - mean when every value is equal."""
    Y = np.asarray(Y)
    m = float(np.mean(Y))
    s = float(np.std(Y))
    return (Y - m) / s if s > 0 else Y - m

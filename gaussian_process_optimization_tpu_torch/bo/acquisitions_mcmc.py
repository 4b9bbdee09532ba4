"""Acquisitions integrated over the HMC hyperparameter samples (twin of
``gaussian_process_optimization_tpu/bo/acquisitions_mcmc.py``; GPyOpt
acquisitions/EI_mcmc.py:29, MPI_mcmc.py, LCB_mcmc.py): the mean over the samples
of the per-sample acquisition.

The samples are the lanes of one ``GPRegression`` (``models/mcmc_bo_model.py``),
so one prediction gives every sample's mean and std, ``(S, M, 1)``, and the
acquisition is their lane mean. The S posteriors are factored once per refit by
the model and handed over by ``device_args``, never per sweep or line-search
call.
"""
from __future__ import annotations

import torch

from ..config import config
from .acquisitions import EI_JITTER, AcquisitionBase, get_quantiles


class _MCMCAcquisitionBase(AcquisitionBase):
    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None):
        super().__init__(model, space, optimizer, cost_withGradients)
        if not getattr(model, "MCMC_sampler", False):
            raise ValueError("Samples from the hyper-parameters are needed to compute the "
                             "integrated acquisition")

    @property
    def supports_device(self):
        return hasattr(self.model, "device_state_mcmc")

    def device_args(self):
        """(lane-batched model, its S posteriors, (S,) fmins, None)."""
        samples, posterior, fmins = self.model.device_state_mcmc()
        return samples, posterior, fmins, None

    def _sample_acq(self, m, s, fmin):
        raise NotImplementedError

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        mu, v = gp.predict(X, posterior=posterior)
        s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        return torch.mean(self._sample_acq(mu, s, fmin[:, None, None]), dim=0)


class AcquisitionEI_MCMC(_MCMCAcquisitionBase):
    """(EI_mcmc.py:29): (fmin - m + xi) Phi + s phi per sample, as the reference
    writes it."""

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 jitter=EI_JITTER):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def _sample_acq(self, m, s, fmin):
        phi, Phi, _ = get_quantiles(self.jitter, fmin, m, s)
        return (fmin - m + self.jitter) * Phi + s * phi


class AcquisitionMPI_MCMC(_MCMCAcquisitionBase):
    """(MPI_mcmc.py): Phi(u) per sample."""

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 jitter=EI_JITTER):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def _sample_acq(self, m, s, fmin):
        return get_quantiles(self.jitter, fmin, m, s)[1]


class AcquisitionLCB_MCMC(_MCMCAcquisitionBase):
    """(LCB_mcmc.py): -m + w s per sample; it ignores the cost, as LCB does."""

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 exploration_weight=2):
        super().__init__(model, space, optimizer, None)
        self.exploration_weight = exploration_weight

    def _sample_acq(self, m, s, fmin):
        return -m + self.exploration_weight * s

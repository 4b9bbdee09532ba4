"""Acquisition functions (twin of ``gaussian_process_optimization_tpu/bo/acquisitions.py``;
GPyOpt acquisitions/base.py:6, EI.py:7, LP.py:10, util/general.py:113).

Each acquisition is tensor code on the surrogate's device:
``pure_neg_acq(gp, posterior, fmin, state, X)`` gives one minimize-convention
value per row of ``X (M, D)``, and each row's value depends on that row alone,
so the optimizer evaluates many points, or many L-BFGS lanes, in one call and
one backward of the sum gives each row its gradient. ``device_args`` gathers
``(gp, posterior, fmin, state)`` from the surrogate. Expected improvement and
its local-penalization wrapper are ported; MPI, LCB and the host-side
``acquisition_function`` API are not yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import config

_SQRT_2PI = math.sqrt(2.0 * math.pi)
_SQRT_2 = math.sqrt(2.0)
# EI's exploration margin xi (GPyOpt AcquisitionEI's default, as in the bench)
EI_JITTER = 0.01


def get_quantiles(acquisition_par, fmin, m, s):
    """(phi, Phi, u): s floored, u = (fmin - m - xi) / s, phi = N(u),
    Phi = erfc(-u / sqrt 2) / 2 (GPyOpt util/general.py:113)."""
    s = torch.clamp(s, min=config.std_floor)
    u = (fmin - m - acquisition_par) / s
    phi = torch.exp(-0.5 * torch.square(u)) / _SQRT_2PI
    Phi = 0.5 * torch.special.erfc(-u / _SQRT_2)
    return phi, Phi, u


def expected_improvement(m, s, fmin):
    """EI = s (u Phi + phi) (EI.py:7), higher is better."""
    phi, Phi, u = get_quantiles(EI_JITTER, fmin, m, s)
    return s * (u * Phi + phi)


def neg_ei(gp, posterior, fmin, X):
    """Minimize-convention EI at ``X (..., M, D)``, shape ``(..., M)``: the
    GP's predictive std with the variance floored at 1e-10 (GPyOpt gpmodel.py:99)."""
    mu, v = gp.predict(X, posterior=posterior)
    s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
    return -expected_improvement(mu, s, fmin)[..., 0]


class AcquisitionBase:
    """Base acquisition (GPyOpt acquisitions/base.py:6): the surrogate, the
    design space, and the optimizer that maximizes it."""

    def __init__(self, model, space, optimizer=None):
        self.model = model
        self.space = space
        self.optimizer = optimizer

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        raise NotImplementedError

    def device_args(self):
        gp, post, fmin = self.model.device_state()
        return gp, post, fmin, None

    def optimize(self, duplicate_manager=None):
        """(base.py:52): (x (1, model_dim), f (1, 1)) from the optimizer."""
        return self.optimizer.optimize(self, duplicate_manager=duplicate_manager)


class AcquisitionEI(AcquisitionBase):
    """Expected improvement (EI.py:7) with xi = 0.01."""

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        return neg_ei(gp, posterior, fmin, X)


class AcquisitionLP(AcquisitionBase):
    """Local penalization for batch BO (LP.py:10, Gonzalez et al. 2016):
    -[log(raw + 1e-50) + sum_j log Phi((|x - x_j| - r_j) / s_j)] over the points
    x_j already in the batch. The batch state (X_batch, r, s) is set by
    :meth:`update_batches`. The softplus transform the reference applies to
    sign-indefinite acquisitions (LCB) is not needed for EI and not ported."""

    def __init__(self, model, space, optimizer, acquisition):
        super().__init__(model, space, optimizer)
        self.acq = acquisition
        self.X_batch = None
        self.r_x0 = None
        self.s_x0 = None

    def update_batches(self, X_batch, L, Min):
        """(LP.py:40) hammer radii r = (m - Min) / L and widths s = std / L.

        The reference's deviation from LP.py:55-59 is kept: LP.py takes
        sqrt(std) / L; the reference (acquisitions.py:254-261) takes std / L,
        the width its own docstring describes."""
        self.X_batch = X_batch
        if X_batch is None:
            self.r_x0, self.s_x0 = None, None
            return
        m, s_pred = self.model.predict(np.atleast_2d(X_batch))
        s = np.sqrt(np.maximum(np.square(s_pred), 1e-16))
        self.r_x0 = ((m - Min) / L).flatten()
        self.s_x0 = (s / L).flatten()

    def device_args(self):
        gp, post, fmin, inner = self.acq.device_args()
        batch = None
        if self.X_batch is not None:
            batch = tuple(torch.as_tensor(np.asarray(a, dtype=float), dtype=gp.X.dtype,
                                          device=gp.X.device)
                          for a in (np.atleast_2d(self.X_batch), self.r_x0, self.s_x0))
        return gp, post, fmin, (inner, batch)

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        """Penalized, minimize-convention (LP.py:70-92 _penalized_acquisition)."""
        inner, batch = state if state is not None else (None, None)
        raw = -self.acq.pure_neg_acq(gp, posterior, fmin, inner, X)
        fval = -torch.log(raw + 1e-50)
        if batch is not None:
            X_batch, r, s = batch
            d = torch.sqrt(torch.clamp(
                torch.sum(torch.square(X[:, None, :] - X_batch[None, :, :]), -1), min=1e-32))
            fval = fval - torch.sum(torch.special.log_ndtr((d - r) / s), dim=-1)
        return fval

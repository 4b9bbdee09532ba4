"""Batch evaluators (twin of ``gaussian_process_optimization_tpu/bo/evaluators.py``;
GPyOpt core/evaluators/: sequential.py:7, batch_local_penalization.py:9 with
estimate_L:52). The random and Thompson-sampling batches are not ported yet.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import lbfgs
from .acquisitions import AcquisitionLP


class Sequential:
    """One acquisition argmax per batch (sequential.py:7)."""

    def __init__(self, acquisition, batch_size=1):
        self.acquisition = acquisition
        self.batch_size = batch_size

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        x, _ = self.acquisition.optimize(duplicate_manager=duplicate_manager)
        return x


def _neg_grad_norm(gp, post, X):
    """-|grad mu(x)| of the posterior mean at each row of ``X (M, D)``, shape
    (M,). Each row's mean depends on that row alone, so one backward of the
    summed mean gives every row's gradient. Under grad mode the result stays
    differentiable in ``X`` (a double backward)."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        Xr = X if X.requires_grad else X.detach().requires_grad_(True)
        mu = gp.predict_mean(Xr, post)
        (g,) = torch.autograd.grad(mu.sum(), Xr, create_graph=outer)
    return -torch.sqrt(torch.sum(torch.square(g), dim=-1) + 1e-300)


def estimate_L(model, bounds, seed=0):
    """Lipschitz estimate of the posterior mean (batch_local_penalization.py:52-76):
    max |grad mu| over 500 uniform samples and the training inputs, refined by
    box-bounded L-BFGS (200 steps) from the best of them; L = 10 when it is
    below 1e-7 (a flat model)."""
    gp, post = model.model, model.posterior
    lo = np.asarray([b[0] for b in bounds], dtype=float)
    hi = np.asarray([b[1] for b in bounds], dtype=float)
    rng = np.random.default_rng(seed)
    samples = rng.uniform(lo, hi, size=(500, len(bounds)))
    X_train = gp.X[gp.mask > 0].cpu().numpy()
    samples = np.vstack([samples, X_train])

    def t(a):
        return torch.as_tensor(a, dtype=gp.X.dtype, device=gp.X.device)

    with torch.no_grad():
        vals = _neg_grad_norm(gp, post, t(samples)).cpu().numpy()
    x0 = samples[int(np.argmin(vals))]
    res = lbfgs.minimize(lambda X: _neg_grad_norm(gp, post, X), t(x0), lower=t(lo),
                         upper=t(hi), maxiter=200, carry_graph=False)
    L = float(-res.f)
    if L < 1e-7:
        L = 10.0  # to avoid problems in cases in which the model is flat
    return L


class LocalPenalization:
    """Greedy local-penalization batch (batch_local_penalization.py:9): the
    first point is the acquisition's argmax, each next one the argmax of the
    acquisition penalized around the points chosen so far. ``seconds`` holds
    the last batch's host-clock split: ``estimate_L`` and one entry per argmax
    (each ends in a host read, so the device work is inside)."""

    def __init__(self, acquisition, batch_size):
        if not isinstance(acquisition, AcquisitionLP):
            raise TypeError("LocalPenalization needs an AcquisitionLP")
        self.acquisition = acquisition
        self.batch_size = batch_size
        self.seconds = {}

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        acq = self.acquisition
        seconds = {"estimate_L": 0.0, "argmax": []}
        acq.update_batches(None, None, None)
        t0 = time.perf_counter()
        X_batch, _ = acq.optimize(duplicate_manager=duplicate_manager)
        seconds["argmax"].append(time.perf_counter() - t0)
        if self.batch_size > 1:
            t0 = time.perf_counter()
            L = estimate_L(acq.model, acq.space.get_bounds())
            seconds["estimate_L"] = time.perf_counter() - t0
            Min = acq.model.Y_min()
        while X_batch.shape[0] < self.batch_size:
            acq.update_batches(X_batch, L, Min)
            t0 = time.perf_counter()
            new_sample, _ = acq.optimize(duplicate_manager=duplicate_manager)
            seconds["argmax"].append(time.perf_counter() - t0)
            X_batch = np.vstack((X_batch, new_sample))
        acq.update_batches(None, None, None)
        self.seconds = seconds
        return X_batch

"""BO surrogate wrapper (twin of ``gaussian_process_optimization_tpu/models/bo_models.py``;
GPyOpt models/gpmodel.py:9 ``GPModel``).

The GPyOpt-side conventions: ``predict`` returns (mean, std) with the variance
floored at 1e-10 (gpmodel.py:99-102); ``get_fmin`` is the smallest posterior
mean at the training inputs (:125); the default kernel is Matern52, Gower-wrapped
with the design space's continuous ranges when ``Gower`` is set (:58); the
default noise is var(Y) * 0.01 (:64), fixed at 1e-6 under ``exact_feval`` and
bounded to [1e-9, 1e6] otherwise (:72-76); ``updateModel`` refits by
multi-restart L-BFGS (:88-93).

As in the reference, the data sit in buffers padded to a power of two with a
mask, and the jitter ladder is warm-started across refits: fit trials run the
greedy ladder from ``jitter_hint``, the posterior re-verifies the minimal rung,
and that rung is the next refit's hint. ``ladder`` records, per refit, the
hint the fit started from and the posterior's rung.

Tensors live on ``device`` (the card unless another is named) in ``dtype``;
fit restarts draw from ``generator`` (a ``torch.Generator`` on that device,
seeded from ``seed`` by default).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config, resolve_device
from ..kernels.gower import Gower
from ..kernels.stationary import Matern52
from .fit import Fitter
from .gp import GPRegression
from .parameters import bounded_noise_transform


def _bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two padding bucket (bo_models.py:35)."""
    return max(minimum, 2 ** math.ceil(math.log2(max(n, 1))))


class GPModel:
    """Exact, padded GP surrogate (GPyOpt gpmodel.py:9)."""

    def __init__(self, kernel=None, noise_var=None, exact_feval=False, max_iters=1000,
                 optimize_restarts=5, ARD=False, Gower=False, space=None, seed=0,
                 device=None, dtype=torch.float64, generator=None):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.max_iters = max_iters
        self.optimize_restarts = optimize_restarts
        self.ARD = ARD
        self.Gower = Gower
        self.space = space
        self.device = resolve_device(device)
        self.dtype = dtype
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.model: GPRegression | None = None
        self.posterior = None
        self.ladder: list[dict] = []
        self._fitters: dict = {}
        self._fmin = None

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                               device=self.device)

    def _default_kernel(self, input_dim):
        """Matern52 (ARD if asked), Gower-wrapped with the space's continuous
        ranges (bo_models.py:134-155). The kernel slices model-space X, so the
        column indices come from the model-space slices; one-hot categorical
        columns take the discrete (Hamming) branch."""
        base = Matern52.create(input_dim, variance=1.0, ARD=self.ARD, dtype=self.dtype,
                               device=self.device)
        if not (self.Gower and self.space is not None):
            return base
        cont, disc = [], []
        for v, sl in zip(self.space.space_expanded, self.space._model_slices):
            (cont if v.is_continuous else disc).extend(range(sl.start, sl.stop))
        return Gower.create(base, ranges=self.space.lengthscales(), cont_dims=cont,
                            disc_dims=disc, gpy_compat=True)

    def _create_model(self, X, Y, max_points):
        noise = self.noise_var if self.noise_var is not None else float(np.var(Y)) * 0.01
        if self.exact_feval:
            noise = 1e-6
        kern = self.kernel_template
        if kern is None:
            kern = self._default_kernel(X.shape[1])
        model = GPRegression.create(X, Y, kernel=kern, noise_var=noise,
                                    max_points=max_points, dtype=self.dtype,
                                    device=self.device)
        self.model = dataclasses.replace(
            model, jitter_hint=torch.zeros((), dtype=torch.float32, device=self.device),
            jitter_greedy=True)

    def _fitter_for(self, bucket):
        if bucket not in self._fitters:
            if self.exact_feval:
                fix, overrides = ("likelihood_variance",), None
            else:
                fix, overrides = (), {"likelihood_variance": bounded_noise_transform()}
            self._fitters[bucket] = Fitter(self.model, num_restarts=self.optimize_restarts,
                                           maxiter=self.max_iters, fix=fix,
                                           transform_overrides=overrides)
        return self._fitters[bucket]

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        """Refit on all data (gpmodel.py:78-93, bo_models.py:206-237)."""
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        if self.model is None:
            self._create_model(X_all, Y_all, max_points=bucket)
        else:
            self.model = self.model.with_data(X_all, Y_all, max_points=bucket)
        hint = self.model.jitter_hint
        if self.max_iters > 0:
            self.model, _ = self._fitter_for(bucket)(self.model, self.generator)
        # the posterior re-verifies the minimal rung; it is the next refit's hint
        with torch.no_grad():
            self.posterior = dataclasses.replace(self.model, jitter_greedy=False).inference(
                precompute_inverse=True)
        self.model = dataclasses.replace(self.model,
                                         jitter_hint=self.posterior.rung.to(torch.float32))
        self.ladder.append({"fit_hint": int(hint), "posterior_rung": int(self.posterior.rung)})
        self._fmin = None

    def predict(self, X):
        """(mean, std) as numpy, the variance floored at 1e-10 (gpmodel.py:102-124)."""
        with torch.no_grad():
            mu, v = self.model.predict(self._tensor(np.atleast_2d(X)), posterior=self.posterior)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        return mu.cpu().numpy(), s.cpu().numpy()

    def predict_withGradients(self, X):
        """(m, s, dm/dx, ds/dx) as numpy; ds = dv/dx / (2 s) (gpmodel.py:131-141)."""
        X = self._tensor(np.atleast_2d(X))
        with torch.no_grad():
            mu, v = self.model.predict(X, posterior=self.posterior)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        dm, dv = self.model.predictive_gradients(X, posterior=self.posterior)
        return tuple(t.cpu().numpy() for t in (mu, s, dm[:, :, 0], dv / (2.0 * s)))

    def get_fmin(self) -> float:
        """Smallest posterior mean at the real training rows (gpmodel.py:125-129),
        cached per refit."""
        if self._fmin is None:
            with torch.no_grad():
                mu = self.model.predict_mean(self.model.X, self.posterior)
                mu = torch.where(self.model.mask[:, None] > 0, mu,
                                 torch.full_like(mu, float("inf")))
            self._fmin = float(torch.min(mu))
        return self._fmin

    def Y_min(self) -> float:
        """Smallest real training target, LP's ``Min`` (batch_local_penalization.py:44)."""
        Y = self.model.Y[self.model.mask > 0]
        return float(Y.min())

    def device_state(self):
        """(model, posterior, fmin) for the acquisitions' tensor code."""
        fmin = torch.tensor(self.get_fmin(), dtype=self.dtype, device=self.device)
        return self.model, self.posterior, fmin

"""Sparse-GP BO surrogate (twin of
``gaussian_process_optimization_tpu/models/sparse_bo_model.py``; GPyOpt
``model_type='sparseGP'``: arguments_manager.py:80 builds GPModel(sparse=True,
num_inducing), gpmodel.py:66-69 GPy's SparseGPRegression).

A Matern52 kernel by default, ``num_inducing`` clipped to the number of points,
the noise bounded to [1e-9, 1e6] unless ``exact_feval`` fixes it at 1e-6, data
padded to power-of-two buckets, and one multi-restart L-BFGS fit of the bound
per refit, its restarts drawn from ``generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.stationary import Matern52
from .bo_models import (BOModel, _bucket, default_noise, masked_fmin,
                        parameter_names, parameter_rows, real_Y_min)
from .fit import Fitter
from .parameters import bounded_noise_transform
from .sparse import SparseGPRegression


class SparseGPModel(BOModel):
    analytical_gradient_prediction = True

    def __init__(self, kernel=None, noise_var=None, exact_feval=False, optimizer="lbfgs",
                 max_iters=1000, optimize_restarts=5, num_inducing=10, verbose=False,
                 ARD=False, inference="vardtc", seed=0, device=None, dtype=None,
                 generator=None):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.optimizer_name = optimizer
        self.max_iters = max_iters
        self.optimize_restarts = optimize_restarts
        self.num_inducing = num_inducing
        self.verbose = verbose
        self.ARD = ARD
        self.inference = inference
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.model: SparseGPRegression | None = None
        self.posterior = None
        self._fitters = {}
        self._fmin = None

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        if self.model is None:
            kern = self.kernel_template or Matern52.create(
                X_all.shape[1], ARD=self.ARD, dtype=self.dtype, device=self.device)
            self.model = SparseGPRegression.create(
                X_all, Y_all, kernel=kern, num_inducing=min(self.num_inducing, len(X_all)),
                noise_var=default_noise(self.noise_var, self.exact_feval, Y_all),
                inference=self.inference, max_points=bucket, dtype=self.dtype,
                device=self.device)
        else:
            self.model = self.model.with_data(X_all, Y_all, max_points=bucket)
        if bucket not in self._fitters:
            if self.exact_feval:
                fix, overrides = ("likelihood_variance",), None
            else:
                fix, overrides = (), {"likelihood_variance": bounded_noise_transform()}
            self._fitters[bucket] = Fitter(self.model, num_restarts=self.optimize_restarts,
                                           maxiter=self.max_iters, fix=fix,
                                           transform_overrides=overrides)
        if self.max_iters > 0:
            self.model, _ = self._fitters[bucket](self.model, self.generator)
        with torch.no_grad():
            self.posterior = self.model.inference_state()
        self._fmin = None

    def _tensor(self, x):
        return torch.as_tensor(np.atleast_2d(np.asarray(x, dtype=float)), dtype=self.dtype,
                               device=self.device)

    def predict(self, X):
        """(mean, std) as numpy, the variance floored at 1e-10."""
        with torch.no_grad():
            mu, v = self.model.predict(self._tensor(X), posterior=self.posterior)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        return mu.cpu().numpy(), s.cpu().numpy()

    def predict_withGradients(self, X):
        X = self._tensor(X)
        with torch.no_grad():
            mu, v = self.model.predict(X, posterior=self.posterior)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        dm, dv = self.model.predictive_gradients(X, posterior=self.posterior)
        return tuple(t.cpu().numpy() for t in (mu, s, dm[:, :, 0], dv / (2.0 * s)))

    def get_fmin(self) -> float:
        if self._fmin is None:
            with torch.no_grad():
                self._fmin = float(masked_fmin(self.model, self.posterior))
        return self._fmin

    def Y_min(self) -> float:
        return real_Y_min(self.model)

    def get_model_parameters(self):
        return parameter_rows(self.model.kern, self.model.likelihood_variance, lanes=1)

    def get_model_parameters_names(self):
        return parameter_names(self.model.kern, self.model.likelihood_variance)

    def device_state(self):
        fmin = torch.tensor(self.get_fmin(), dtype=self.dtype, device=self.device)
        return self.model, self.posterior, fmin

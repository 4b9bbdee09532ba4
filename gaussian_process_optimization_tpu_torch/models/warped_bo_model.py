"""BO wrappers for the warped GPs (twin of
``gaussian_process_optimization_tpu/models/warped_bo_model.py``; GPyOpt
models/warpedgpmodel.py:15 ``WarpedGPModel``, input_warped_gpmodel.py:9
``InputWarpedGPModel``, which warps the continuous and discrete inputs).

Matern52 by default, ``optimize_restarts`` L-BFGS restarts of ``max_iters``
steps per refit (3 and 500, the reference's defaults), the fitted parameters
carried into the next refit's model. One factorization per refit; every
prediction reuses it. They have no ``device_state``: the acquisitions take
their host face, as the reference's do.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.stationary import Matern52
from .bo_models import BOModel, _bucket, default_noise
from .fit import Fitter
from .warped import InputWarpedGP, WarpedGP


class _WarpedBase(BOModel):
    analytical_gradient_prediction = False

    def __init__(self, kernel=None, noise_var=None, exact_feval=False, optimizer="lbfgs",
                 max_iters=500, optimize_restarts=3, verbose=False, ARD=False, seed=0,
                 device=None, dtype=None, generator=None):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.optimizer_name = optimizer
        self.max_iters = max_iters
        self.optimize_restarts = optimize_restarts
        self.verbose = verbose
        self.ARD = ARD
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.model = None
        self._post = None
        self._fitters = {}

    def _new(self):
        return dict(dtype=self.dtype, device=self.device)

    def _kern(self, d):
        return self.kernel_template or Matern52.create(d, ARD=self.ARD, **self._new())

    def _make(self, X, Y, bucket):
        raise NotImplementedError

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        self.model = self._make(X_all, Y_all, bucket)
        if bucket not in self._fitters:
            fix = ("likelihood_variance",) if self.exact_feval else ()
            self._fitters[bucket] = Fitter(self.model, num_restarts=self.optimize_restarts,
                                           maxiter=self.max_iters, fix=fix)
        self.model, _ = self._fitters[bucket](self.model, self.generator)
        with torch.no_grad():
            self._post = self.model.posterior_cache()

    def _tensor(self, x):
        return torch.as_tensor(np.atleast_2d(np.asarray(x, dtype=float)), **self._new())

    def _mean_std(self, X):
        mu, v = self.model.predict(X, posterior=self._post)
        return mu.reshape(len(X), -1), torch.sqrt(torch.clamp(v, min=config.variance_floor)
                                                  ).reshape(len(X), -1)

    def predict(self, X):
        with torch.no_grad():
            mu, s = self._mean_std(self._tensor(X))
        return mu.cpu().numpy(), s.cpu().numpy()

    def predict_withGradients(self, X):
        """(m, s, dm/dx, ds/dx) by autograd; each row enters only its own
        prediction."""
        with torch.enable_grad():
            X = self._tensor(X).requires_grad_(True)
            mu, s = self._mean_std(X)
            (dm,) = torch.autograd.grad(mu.sum(), X, retain_graph=True)
            (ds,) = torch.autograd.grad(s.sum(), X)
        return tuple(t.detach().cpu().numpy() for t in (mu, s, dm, ds))

    def get_fmin(self) -> float:
        gp = self.model.gp
        with torch.no_grad():
            mu, _ = self.model.predict(gp.X, posterior=self._post)
            mu = mu.reshape(-1)
            if gp.mask is not None:
                mu = torch.where(gp.mask > 0, mu, torch.full_like(mu, float("inf")))
        return float(torch.min(mu))


class WarpedGPModel(_WarpedBase):
    """(warpedgpmodel.py:15)"""

    def __init__(self, *args, warping_terms=3, **kw):
        super().__init__(*args, **kw)
        self.warping_terms = warping_terms

    def _make(self, X, Y, bucket):
        m = WarpedGP.create(X, Y, kernel=self._kern(X.shape[1]),
                            noise_var=default_noise(self.noise_var, self.exact_feval, Y),
                            warping_terms=self.warping_terms, max_points=bucket,
                            **self._new())
        if self.model is not None:
            # the fitted warp, kernel and noise carry over (warped_bo_model.py:120-132)
            m = dataclasses.replace(m, warp=self.model.warp, gp=dataclasses.replace(
                m.gp, kern=self.model.gp.kern,
                likelihood_variance=self.model.gp.likelihood_variance))
        return m


class InputWarpedGPModel(_WarpedBase):
    """(input_warped_gpmodel.py:9): warps the continuous and discrete inputs."""

    def __init__(self, space=None, *args, **kw):
        super().__init__(*args, **kw)
        self.space = space

    def _make(self, X, Y, bucket):
        warping_indices = None
        if self.space is not None:
            warping_indices = sorted(self.space.get_continuous_dims()
                                     + self.space.get_discrete_dims())
        m = InputWarpedGP.create(X, Y, kernel=self._kern(X.shape[1]),
                                 noise_var=default_noise(self.noise_var, self.exact_feval, Y),
                                 warping_indices=warping_indices, max_points=bucket,
                                 **self._new())
        if self.model is not None:
            # the fitted warp (new input ranges), kernel and noise carry over
            # (warped_bo_model.py:142-159)
            m = dataclasses.replace(
                m, warp=dataclasses.replace(self.model.warp, lo=m.warp.lo, hi=m.warp.hi),
                gp=dataclasses.replace(m.gp, kern=self.model.gp.kern,
                                       likelihood_variance=self.model.gp.likelihood_variance))
        return m

"""GP surrogate with its hyperparameters integrated out by HMC (twin of
``gaussian_process_optimization_tpu/models/mcmc_bo_model.py``; GPyOpt
models/gpmodel.py:180 ``GPModel_MCMC``).

The reference's behaviour (gpmodel.py:213-255): an RBF kernel by default,
Gamma(E=2, V=4) priors on the kernel's parameters and the noise (gpmodel.py:231-232),
the noise var(Y) * 0.01 by default and fixed at 1e-6 under ``exact_feval``; each
refit optimizes the posterior for 200 steps, perturbs the packed parameters by
x(1 + 0.01 eps), runs ``n_burnin + n_samples * subsample_interval`` HMC steps
(step 0.1, 20 leapfrog steps) and keeps every ``subsample_interval``-th sample
after the burn-in; the predictions are per-sample lists.

The S kept samples are the lane axis: ``Packer.unpack`` of the ``(S, P)`` sample
matrix gives one lane-batched ``GPRegression``, and one
``inference(precompute_inverse=True)`` factors all S posteriors in one batched
call per refit. ``device_state_mcmc`` hands both to the ``_MCMC`` acquisitions.

Draws come from ``generator``; ``draws(num_steps, dim) -> (eps (dim,), momenta
(num_steps, dim), log_uniforms (num_steps,))`` replaces them (the parity tests
give the reference's).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..utils.priors import GammaPrior
from .bo_models import (BOModel, _bucket, default_noise, masked_fmin,
                        parameter_names, parameter_rows, real_Y_min)
from .fit import Fitter
from .gp import GPRegression
from .hmc import hmc_draws, hmc_sample
from .parameters import make_packer

# the posterior optimization before sampling (gpmodel.py:247)
FIT_STEPS = 200


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GPModel_MCMC(BOModel):
    """(gpmodel.py:180) The point-estimate fit is ``model``; the kept samples
    are the lanes of ``samples`` with their posteriors in ``samples_posterior``.
    ``seconds`` holds the last refit's host-clock split (fit, HMC) and
    ``accept_rate`` its HMC accept rate."""

    MCMC_sampler = True
    analytical_gradient_prediction = True

    def __init__(self, kernel=None, noise_var=None, exact_feval=False, n_samples=10,
                 n_burnin=100, subsample_interval=10, step_size=1e-1, leapfrog_steps=20,
                 verbose=False, seed=0, device=None, dtype=None, generator=None,
                 draws=None):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.n_samples = n_samples
        self.n_burnin = n_burnin
        self.subsample_interval = subsample_interval
        self.step_size = step_size
        self.leapfrog_steps = leapfrog_steps
        self.verbose = verbose
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.draws = draws
        self.model: GPRegression | None = None
        self.samples: GPRegression | None = None
        self.samples_posterior = None
        self.hmc_samples = None
        self.accept_rate = None
        self.seconds = {}
        self._fitters = {}
        self._fmins = None

    def _priors(self):
        g = GammaPrior.from_EV(2.0, 4.0)
        priors = {"variance": g, "lengthscale": g}
        if not self.exact_feval:
            priors["likelihood_variance"] = g
        return priors

    def _fitter_for(self, bucket):
        if bucket not in self._fitters:
            fix = ("likelihood_variance",) if self.exact_feval else ()
            self._fitters[bucket] = Fitter(self.model, num_restarts=1, maxiter=FIT_STEPS,
                                           fix=fix, priors=self._priors())
        return self._fitters[bucket]

    def _draw(self, num_steps, dim, like):
        if self.draws is not None:
            return tuple(torch.as_tensor(np.asarray(a, dtype=float), dtype=like.dtype,
                                         device=like.device)
                         for a in self.draws(num_steps, dim))
        eps = torch.randn((dim,), generator=self.generator, dtype=like.dtype,
                          device=like.device)
        return (eps,) + hmc_draws(num_steps, dim, self.generator, like)

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        """Fit, then sample (gpmodel.py:236-255)."""
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        if self.model is None:
            kern = self.kernel_template or RBF.create(X_all.shape[1], dtype=self.dtype,
                                                      device=self.device)
            self.model = GPRegression.create(
                X_all, Y_all, kernel=kern,
                noise_var=default_noise(self.noise_var, self.exact_feval, Y_all),
                max_points=bucket, dtype=self.dtype, device=self.device)
        else:
            self.model = self.model.with_data(X_all, Y_all, max_points=bucket)
        fitter = self._fitter_for(bucket)
        t0 = time.perf_counter()
        self.model, _ = fitter(self.model, self.generator)
        _synchronize(self.device)
        t1 = time.perf_counter()

        packer, model = fitter.packer, self.model
        u0 = packer.pack(model).detach()
        total = self.n_burnin + self.n_samples * self.subsample_interval
        eps, momenta, log_u = self._draw(total, u0.shape[0], u0)
        # the x(1 + 0.01 eps) perturbation (gpmodel.py:251), in the packed coordinates
        u0 = u0 * (1.0 + 0.01 * eps)
        chain, rate = hmc_sample(lambda u: fitter.objective(u[None], model)[0], u0, None,
                                 total, stepsize=self.step_size,
                                 leapfrog_steps=self.leapfrog_steps, draws=(momenta, log_u))
        kept = chain[self.n_burnin::self.subsample_interval][:self.n_samples]
        self.accept_rate = float(rate)
        t2 = time.perf_counter()
        self.set_samples(model, kept)
        _synchronize(self.device)
        self.seconds = {"fit": t1 - t0, "hmc": t2 - t1,
                        "posterior": time.perf_counter() - t2}
        if self.verbose:
            print(f"HMC accept rate: {self.accept_rate:.2f}")

    def set_samples(self, model: GPRegression, samples):
        """Take ``model`` as the point estimate and the rows of ``samples`` (S,
        P), packed parameter vectors, as the kept samples: one lane-batched model
        and its S posteriors, factored in one batched call."""
        self.model = model
        kept = torch.as_tensor(np.asarray(samples, dtype=float) if not isinstance(
            samples, torch.Tensor) else samples, dtype=self.dtype, device=self.device)
        fix = ("likelihood_variance",) if self.exact_feval else ()
        self.hmc_samples = kept.cpu().numpy()
        self.samples = make_packer(model, fix=fix).unpack(kept, reference=model)
        with torch.no_grad():
            self.samples_posterior = self.samples.inference(precompute_inverse=True)
        self._fmins = None

    def _tensor(self, x):
        return torch.as_tensor(np.atleast_2d(np.asarray(x, dtype=float)), dtype=self.dtype,
                               device=self.device)

    def _predict(self, X):
        mu, v = self.samples.predict(X, posterior=self.samples_posterior)
        return mu, torch.sqrt(torch.clamp(v, min=config.variance_floor))

    def predict(self, X):
        """Per-sample lists of (means (M, 1), stds (M, 1)) (gpmodel.py:257-277)."""
        with torch.no_grad():
            mu, s = self._predict(self._tensor(X))
        return list(mu.cpu().numpy()), list(s.cpu().numpy())

    def predict_withGradients(self, X):
        """Per-sample lists of (m, s, dm/dx (M, D), ds/dx (M, D)): every lane
        differentiates its own copy of ``X``."""
        X = self._tensor(X)
        with torch.enable_grad():
            Xs = X.expand((self.n_lanes,) + tuple(X.shape)).clone().requires_grad_(True)
            mu, v = self.samples.predict(Xs, posterior=self.samples_posterior)
            (dm,) = torch.autograd.grad(mu.sum(), Xs, retain_graph=True)
            (dv,) = torch.autograd.grad(v.sum(), Xs)
        s = torch.sqrt(torch.clamp(v.detach(), min=config.variance_floor))
        out = (mu.detach(), s, dm, dv / (2.0 * s))
        return tuple(list(t.cpu().numpy()) for t in out)

    @property
    def n_lanes(self) -> int:
        return self.hmc_samples.shape[0]

    def _fmin_lanes(self):
        if self._fmins is None:
            with torch.no_grad():
                self._fmins = masked_fmin(self.samples, self.samples_posterior)
        return self._fmins

    def get_fmin(self):
        """Per-sample minima of the posterior mean at the real rows (gpmodel.py:279-295)."""
        return list(self._fmin_lanes().cpu().numpy())

    def Y_min(self) -> float:
        return real_Y_min(self.model)

    def get_model_parameters(self):
        """The ``(S, P)`` matrix of kept samples, kernel leaves then the noise
        (gpmodel.py:247-255)."""
        return parameter_rows(self.samples.kern, self.samples.likelihood_variance,
                              lanes=self.n_lanes,
                              like=(self.model.kern, self.model.likelihood_variance))

    def get_model_parameters_names(self):
        return parameter_names(self.model.kern, self.model.likelihood_variance)

    def device_state_mcmc(self):
        """(lane-batched model, its S posteriors, (S,) fmins) for the ``_MCMC``
        acquisitions."""
        return self.samples, self.samples_posterior, self._fmin_lanes()

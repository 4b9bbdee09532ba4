"""Acquisition functions (twin of ``gaussian_process_optimization_tpu/bo/acquisitions.py``;
GPyOpt acquisitions/base.py:6, EI.py:7, MPI.py:7, LCB.py:7, LP.py:10,
util/general.py:113).

Two faces per acquisition, as in the reference:

- tensor code on the surrogate's device: ``pure_raw_acq(gp, posterior, fmin,
  state, X)`` gives one value (higher is better) per row of ``X (M, D)``, shape
  ``(M, 1)``, and ``pure_neg_acq`` its minimize-convention ``(M,)``. Each row's
  value depends on that row alone, so the optimizer evaluates many points, or
  many L-BFGS lanes, in one call and one backward of the sum gives each row its
  gradient. ``device_args`` gathers ``(gp, posterior, fmin, state)``.
- the GPyOpt host API on numpy arrays: ``acquisition_function(x) =
  -(raw * indicator) / cost`` (base.py:33) and
  ``acquisition_function_withGradients`` (:42), which the host optimizers
  (``optimizer.optimize_host``) call one point at a time.

A surrogate without tensor state (the random forest, the warped GPs: no
``device_state``) has only the host face: ``supports_device`` is false, the raw
acquisition comes from its numpy ``predict`` (EI.py:32), its gradient by the
chain rule through ``predict_withGradients`` (EI.py:42-51), and the host
optimizer maximizes it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import config
from ..utils.profiling import host

_SQRT_2PI = math.sqrt(2.0 * math.pi)
_SQRT_2 = math.sqrt(2.0)
# EI's and MPI's exploration margin xi (GPyOpt's default)
EI_JITTER = 0.01


def constant_cost_withGradients(x):
    """Unit cost (GPyOpt core/task/cost.py constant_cost_withGradients)."""
    x = np.atleast_2d(x)
    return np.ones((x.shape[0], 1)), np.zeros_like(x)


def get_quantiles(acquisition_par, fmin, m, s):
    """(phi, Phi, u): s floored, u = (fmin - m - xi) / s, phi = N(u),
    Phi = erfc(-u / sqrt 2) / 2 (GPyOpt util/general.py:113)."""
    s = torch.clamp(s, min=config.std_floor)
    u = (fmin - m - acquisition_par) / s
    phi = torch.exp(-0.5 * torch.square(u)) / _SQRT_2PI
    Phi = 0.5 * torch.special.erfc(-u / _SQRT_2)
    return phi, Phi, u


def _pure_predict(gp, posterior, X):
    """(m, s) in GPyOpt's convention: mean and std, the variance floored at
    1e-10 (gpmodel.py:99-102)."""
    mu, v = gp.predict(X, posterior=posterior)
    return mu, torch.sqrt(torch.clamp(v, min=config.variance_floor))


def expected_improvement(m, s, fmin, jitter=EI_JITTER):
    """EI = s (u Phi + phi) (EI.py:7), higher is better."""
    phi, Phi, u = get_quantiles(jitter, fmin, m, s)
    return s * (u * Phi + phi)


def neg_ei(gp, posterior, fmin, X):
    """Minimize-convention EI at ``X (..., M, D)``, shape ``(..., M)``."""
    mu, s = _pure_predict(gp, posterior, X)
    return -expected_improvement(mu, s, fmin)[..., 0]


class AcquisitionBase:
    """Base acquisition (GPyOpt acquisitions/base.py:6): the surrogate, the
    design space, the optimizer that maximizes it, and the evaluation cost it
    is divided by on the host side."""

    analytical_gradient_prediction = False

    def __init__(self, model, space, optimizer=None, cost_withGradients=None):
        self.model = model
        self.space = space
        self.optimizer = optimizer
        self.analytical_gradient_acq = (
            self.analytical_gradient_prediction
            and getattr(model, "analytical_gradient_prediction", False))
        self.cost_withGradients = cost_withGradients or constant_cost_withGradients

    @property
    def has_cost(self):
        return self.cost_withGradients is not constant_cost_withGradients

    @property
    def supports_device(self):
        """Whether the surrogate has tensor state for :meth:`device_args`."""
        return hasattr(self.model, "device_state")

    # ------------------------------------------------------------- tensor code
    def host_raw_acq(self, m, s, fmin):
        """The raw acquisition from the predictive mean and std (tensors)."""
        raise NotImplementedError

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        m, s = _pure_predict(gp, posterior, X)
        return self.host_raw_acq(m, s, fmin)

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        """GPyOpt's ``acquisition_function`` sign, without indicator and cost
        (the host side applies those)."""
        return -self.pure_raw_acq(gp, posterior, fmin, state, X)[..., 0]

    def device_args(self):
        gp, post, fmin = self.model.device_state()
        return gp, post, fmin, None

    def _tensor(self, x, gp):
        return torch.as_tensor(np.atleast_2d(np.asarray(x, dtype=float)), dtype=gp.X.dtype,
                               device=gp.X.device)

    # ------------------------------------------------------------- host API
    def _compute_acq(self, x):
        if not self.supports_device:
            m, s = self.model.predict(np.atleast_2d(x))
            t = [torch.as_tensor(np.asarray(a, dtype=float)) for a in (m, s)]
            return self.host_raw_acq(*t, self.model.get_fmin()).numpy()
        return self._compute_acq_device(x)

    def _compute_acq_device(self, x):
        gp, post, fmin, state = self.device_args()
        with torch.no_grad():
            f = self.pure_raw_acq(gp, post, fmin, state, self._tensor(x, gp))
        return host(f).numpy().astype(float)

    def _compute_acq_withGradients(self, x):
        if not self.supports_device:
            # the chain rule through the surrogate's (m, s) and their gradients
            m, s, dmdx, dsdx = (torch.as_tensor(np.asarray(a, dtype=float)) for a in
                                self.model.predict_withGradients(np.atleast_2d(x)))
            with torch.enable_grad():
                m, s = m.requires_grad_(True), s.requires_grad_(True)
                f = self.host_raw_acq(m, s, self.model.get_fmin())
                dfdm, dfds = torch.autograd.grad(f.sum(), (m, s))
            return f.detach().numpy(), (dfdm * dmdx + dfds * dsdx).numpy()
        return self._compute_acq_withGradients_device(x)

    def _compute_acq_withGradients_device(self, x):
        gp, post, fmin, state = self.device_args()
        with torch.enable_grad():
            X = self._tensor(x, gp).requires_grad_(True)
            f = self.pure_raw_acq(gp, post, fmin, state, X)
            (df,) = torch.autograd.grad(f.sum(), X)
        return host(f.detach()).numpy().astype(float), host(df).numpy().astype(float)

    def acquisition_function(self, x):
        """-(raw * indicator) / cost (base.py:33)."""
        f_acqu = self._compute_acq(x)
        cost_x, _ = self.cost_withGradients(x)
        return -(f_acqu * self.space.indicator_constraints(x)) / cost_x

    def acquisition_function_withGradients(self, x):
        """(base.py:42)"""
        f_acqu, df_acqu = self._compute_acq_withGradients(x)
        cost_x, cost_grad_x = self.cost_withGradients(x)
        f_acq_cost = f_acqu / cost_x
        df_acq_cost = (df_acqu * cost_x - f_acqu * cost_grad_x) / (cost_x ** 2)
        ind = self.space.indicator_constraints(x)
        return -f_acq_cost * ind, -df_acq_cost * ind

    def optimize(self, duplicate_manager=None):
        """(base.py:52): (x (1, model_dim), f (1, 1)) from the optimizer, called
        as the reference calls it: a host-only surrogate (the forest) gives
        ``f`` alone, and so does an acquisition without analytical gradients;
        the others give ``f_df`` too. Both give the acquisition where it has
        tensor state, for the device path."""
        if not self.supports_device:
            return self.optimizer.optimize(f=self.acquisition_function,
                                           duplicate_manager=duplicate_manager)
        if not self.analytical_gradient_acq:
            return self.optimizer.optimize(f=self.acquisition_function,
                                           duplicate_manager=duplicate_manager,
                                           acquisition=self)
        return self.optimizer.optimize(f=self.acquisition_function,
                                       f_df=self.acquisition_function_withGradients,
                                       duplicate_manager=duplicate_manager, acquisition=self)


class AcquisitionEI(AcquisitionBase):
    """Expected improvement (EI.py:7): s (u Phi + phi), u = (fmin - m - xi) / s."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 jitter=EI_JITTER):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def host_raw_acq(self, m, s, fmin):
        return expected_improvement(m, s, fmin, self.jitter)


class AcquisitionMPI(AcquisitionBase):
    """Maximum probability of improvement (MPI.py:7): Phi(u)."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 jitter=EI_JITTER):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.jitter = jitter

    def host_raw_acq(self, m, s, fmin):
        return get_quantiles(self.jitter, fmin, m, s)[1]


class AcquisitionLCB(AcquisitionBase):
    """GP lower confidence bound (LCB.py:7): -m + w s. It ignores the cost
    (LCB.py:30)."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 exploration_weight=2):
        super().__init__(model, space, optimizer, None)
        self.exploration_weight = exploration_weight
        if cost_withGradients is not None:
            print("The set cost function is ignored! LCB acquisition does not make sense "
                  "with cost.")

    def host_raw_acq(self, m, s, fmin):
        return -m + self.exploration_weight * s


class AcquisitionLP(AcquisitionBase):
    """Local penalization for batch BO (LP.py:10, Gonzalez et al. 2016):
    -[log g(raw) + sum_j log Phi((|x - x_j| - r_j) / s_j)] over the points x_j
    already in the batch, with g = softplus for a sign-indefinite acquisition
    (LCB) and raw + 1e-50 otherwise (LP.py:31-34, :70-92). The batch state
    (X_batch, r, s) is set by :meth:`update_batches`."""

    analytical_gradient_prediction = True

    def __init__(self, model, space, optimizer, acquisition, transform="none"):
        super().__init__(model, space, optimizer)
        self.acq = acquisition
        self.transform = transform.lower()
        # LCB is sign-indefinite (LP.py:33-34 maps AcquisitionLCB and
        # AcquisitionLCB_MCMC, the latter told by name: it lives in a module
        # that imports this one)
        if self.transform == "none" and (
                isinstance(acquisition, AcquisitionLCB)
                or type(acquisition).__name__ == "AcquisitionLCB_MCMC"):
            self.transform = "softplus"
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
        if isinstance(m, list):
            # an MCMC surrogate's per-sample lists: the radii come from the
            # sample-averaged mean and std (acquisitions.py:266-272)
            m, s_pred = np.mean(np.stack(m), axis=0), np.mean(np.stack(s_pred), axis=0)
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

    def _log_transformed(self, gp, posterior, fmin, inner, X):
        raw = self.acq.pure_raw_acq(gp, posterior, fmin, inner, X)[..., 0]
        if self.transform == "softplus":
            # log(softplus(raw)); above 40, softplus(x) ~= x (LP.py:79-81). Both
            # branches get a gradient, so the exp's argument is clamped first.
            return torch.where(
                raw >= 40.0, torch.log(torch.clamp(raw, min=1e-50)),
                torch.log(torch.log1p(torch.exp(torch.clamp(raw, max=40.0)))))
        return torch.log(raw + 1e-50)

    def pure_neg_acq(self, gp, posterior, fmin, state, X):
        """Penalized, minimize-convention (LP.py:70-92 _penalized_acquisition)."""
        inner, batch = state if state is not None else (None, None)
        fval = -self._log_transformed(gp, posterior, fmin, inner, X)
        if batch is not None:
            X_batch, r, s = batch
            d = torch.sqrt(torch.clamp(
                torch.sum(torch.square(X[:, None, :] - X_batch[None, :, :]), -1), min=1e-32))
            fval = fval - torch.sum(torch.special.log_ndtr((d - r) / s), dim=-1)
        return fval

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        return -self.pure_neg_acq(gp, posterior, fmin, state, X)[..., None]

    # GPyOpt's LP returns the penalized log-space value directly
    def acquisition_function(self, x):
        return -self._compute_acq_device(x)

    def acquisition_function_withGradients(self, x):
        f, df = self._compute_acq_withGradients_device(x)
        return -f, -df

    def optimize(self, duplicate_manager=None):
        """(acquisitions.py:339): always with ``f_df`` and the acquisition."""
        return self.optimizer.optimize(f=self.acquisition_function,
                                       f_df=self.acquisition_function_withGradients,
                                       duplicate_manager=duplicate_manager, acquisition=self)

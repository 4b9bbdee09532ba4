"""Latent inputs for new observations, ``infer_newX`` (twin of
``gaussian_process_optimization_tpu/models/inference_x.py``; GPy
inference/latent_function_inference/inferenceX.py).

Given a trained latent-variable model and new rows Y*, find where each row
lives in latent space with the trained posterior held fixed: a point X* for
the point GPLVM (a GPRegression with trained X), q(x*) = N(mu*, diag(S*)) for
the Bayesian GPLVM. The objective decomposes over the new rows, so each row is
one lane of the lane-axis L-BFGS (``ops/lbfgs.py``), where the reference vmaps
one L-BFGS per row. Every trial evaluates all rows at once as one batch of
test points (one K(X, X*) for all of them); lane b reads row b only.

- Point case: -E_post[log N(y | f(x), sigma^2)] over the observed entries,
  0.5 beta (sum_d v_d (y_d - m_d)^2 + |v| var), (m, var) the posterior
  predictive at x and v the row's mask of non-NaN entries (inferenceX.py:125-144).
- Uncertain case: the psi-statistics contraction with the collapsed bound's
  q(u) (wv, Wi) folded into constants (inferenceX.py:120-168), minus
  KL(q(x*) || N(0, I)); the lane's parameters are (mu, log S).

Starting points (inferenceX.py:87-115): the nearest training row in Y space
('L2' squared distance over the observed entries, 'NCC' the argmin of the dot
product as the reference writes it, 'rand' a uniform draw, whose indices a
caller may hand in as ``init_idx``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import lbfgs
from .gp import GPRegression
from .gplvm import BayesianGPLVM, rbf_psi_stats_n


@dataclasses.dataclass(frozen=True)
class NormalLatentPosterior:
    """q(X*) = N(mean, diag(variance)) (inferenceX.py:27)."""

    mean: torch.Tensor = None      # (N*, Q)
    variance: torch.Tensor = None  # (N*, Q)


def _init_idx(Y_train, Y_new, init="L2", valid=None, generator=None):
    """Index of each new row's starting training row (inferenceX.py:87-106).
    ``valid (N*, P)`` restricts the distances to each row's observed entries
    (the reference's missing-data path, per row here)."""
    Y_train = np.asarray(Y_train, dtype=float)
    Y_new = np.asarray(Y_new, dtype=float)
    if init == "rand":
        return torch.randint(0, Y_train.shape[0], (Y_new.shape[0],),
                             generator=generator).numpy()
    if valid is None:
        valid = np.ones(Y_new.shape, dtype=bool)
    Yn = np.where(valid, Y_new, 0.0)
    if init == "NCC":
        dist = Yn @ Y_train.T
    elif init == "L2":
        dist = (-2.0 * Yn @ Y_train.T + np.square(Yn).sum(1)[:, None]
                + valid.astype(float) @ np.square(Y_train).T)
    else:
        raise ValueError(f"unknown init {init!r} (use 'L2', 'NCC' or 'rand')")
    return dist.argmin(axis=1)


def infer_newX(model, Y_new, optimize=True, init="L2", maxiter=200, generator=None, *,
               init_idx=None):
    """Latent positions for new observations ``Y_new (N*, P)`` in the model's
    own Y space (a BayesianGPLVM keeps centred Y: centre the rows the same
    way). NaN entries are unobserved. ``init_idx`` overrides the starting rows
    (the 'rand' draws of the reference, injected); ``generator`` draws them
    otherwise. Returns ``(X, info)``: an ``(N*, Q)`` tensor for a point model,
    a :class:`NormalLatentPosterior` for a BayesianGPLVM; ``info["objective"]``
    holds each row's final objective."""
    if isinstance(model, BayesianGPLVM):
        ref = model.Z
    elif isinstance(model, GPRegression):
        ref = model.X
    else:
        raise TypeError("infer_newX takes a GPRegression (point GPLVM) or a BayesianGPLVM, "
                        f"got {type(model).__name__}")
    Y_new = torch.as_tensor(Y_new, dtype=ref.dtype, device=ref.device)
    if Y_new.ndim == 1:
        Y_new = Y_new[:, None]
    if isinstance(model, BayesianGPLVM):
        return _uncertain(model, Y_new, optimize, init, maxiter, init_idx, generator)
    return _point(model, Y_new, optimize, init, maxiter, init_idx, generator)


def _solve(objective, U0, optimize, maxiter):
    """(rows' final parameters, their objectives): one L-BFGS lane per row."""
    if not optimize:
        with torch.no_grad():
            return U0, objective(U0)
    res = lbfgs.minimize(objective, U0, maxiter=maxiter, carry_graph=False)
    return res.x, res.f


def _point(model, Y_new, optimize, init, maxiter, idx, generator):
    if model.normalizer is not None:
        Y_new = model.normalizer.normalize(Y_new)
    X_train, Y_train = model.X, model.Y
    if model.mask is not None:
        n_real = int(torch.sum(model.mask))
        X_train, Y_train = X_train[:n_real], Y_train[:n_real]
    valid = ~torch.isnan(Y_new)
    Y_filled = torch.where(valid, Y_new, torch.zeros_like(Y_new))
    if idx is None:
        valid_np = valid.cpu().numpy()
        idx = _init_idx(Y_train.cpu().numpy(), Y_filled.cpu().numpy(), init,
                       valid=None if valid_np.all() else valid_np, generator=generator)
    X0 = X_train[torch.as_tensor(np.asarray(idx), device=X_train.device)].detach()

    post = model.inference(precompute_inverse=True)
    sigma2 = model._noise_at_test("mean")
    beta = 1.0 / torch.clamp(sigma2, min=1e-6)
    V = valid.to(Y_filled.dtype)
    p_eff = torch.sum(V, dim=1)

    def objective(X):
        mu, var = model._raw_predict(X, posterior=post)
        return 0.5 * beta * (torch.sum(V * torch.square(Y_filled - mu), dim=1)
                             + p_eff * var[:, 0])

    xs, fs = _solve(objective, X0, optimize, maxiter)
    return xs, {"objective": fs}


def _uncertain(model, Y_new, optimize, init, maxiter, idx, generator):
    kern, Z = model.kern, model.Z
    beta = 1.0 / torch.clamp(model.likelihood_variance, min=1e-6)
    P = model.Y.shape[1]
    Q = model.q_mu.shape[1]
    with torch.no_grad():
        wv, Wi = model.posterior_u()
        dL2 = 0.5 * beta * (P * Wi - wv @ wv.transpose(0, 1))  # dL_dpsi2 (compute_dL)
    if idx is None:
        idx = _init_idx(model.Y.cpu().numpy(), Y_new.cpu().numpy(), init, generator=generator)
    idx = torch.as_tensor(np.asarray(idx), device=Z.device)
    U0 = torch.cat([model.q_mu[idx], torch.log(model.q_S[idx])], dim=1).detach()

    def objective(U):
        mu, S = U[:, :Q], torch.exp(U[:, Q:])
        _, psi1, psi2n = rbf_psi_stats_n(kern, Z, mu, S)  # psi0 of a row: the variance
        val = (torch.sum(dL2 * psi2n, dim=(1, 2)) + beta * torch.sum(Y_new * (psi1 @ wv), dim=1)
               - 0.5 * beta * P * kern.variance)
        kl = 0.5 * torch.sum(torch.square(mu) + S - torch.log(S) - 1.0, dim=1)
        return -(val - kl)

    us, fs = _solve(objective, U0, optimize, maxiter)
    return (NormalLatentPosterior(mean=us[:, :Q], variance=torch.exp(us[:, Q:])),
            {"objective": fs})

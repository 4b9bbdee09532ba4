"""Multi-output (coregionalized) GP regression (twin of
``gaussian_process_optimization_tpu/models/multioutput.py``; GPy
util/multioutput.py, models/gp_coregionalized_regression.py,
sparse_gp_coregionalized_regression.py, sparse_gp_regression_md.py).

Outputs are stacked with a task-index column; the ICM kernel is
K_data(x, x') B[task, task'] with B = W W^T + diag(kappa)
(``kernels/other.Coregionalize``). The data kernel reads the input columns
through ``active_dims``, so a stationary one passes the CUDA kernels' gate on
the stacked input and the fit runs the K build, its backward and the
triangular inverse as the main path does.

``SparseGPRegressionMD.optimize`` draws its restarts from a ``torch.Generator``
(the reference uses ``jax.random``), and takes the starts if handed them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import config
from ..kernels.base import placement
from ..kernels.other import Coregionalize
from ..kernels.stationary import RBF
from ..ops import lbfgs, linalg
from . import fit as fit_module
from .gp import GPRegression
from .parameters import make_packer
from .sparse import SparseGPRegression


def build_stacked_XY(X_list, Y_list):
    """Per-output datasets stacked with a task-index column (GPy
    util/multioutput.build_XY), numpy float64."""
    Xs, Ys = [], []
    for i, (X, Y) in enumerate(zip(X_list, Y_list)):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        Xs.append(np.hstack([X, np.full((len(X), 1), float(i))]))
        Ys.append(np.asarray(Y, dtype=float).reshape(len(X), 1))
    return np.vstack(Xs), np.vstack(Ys)


def icm_kernel(input_dim, num_outputs, base_kernel=None, rank=1, W=None, kappa=None,
               dtype=None, device=None):
    """K_data * B (GPy util/multioutput.ICM): the data kernel on columns
    0..input_dim-1, the coregionalization on column input_dim. The new leaves
    take the base kernel's dtype and device."""
    if base_kernel is None:
        base_kernel = RBF.create(input_dim, dtype=dtype, device=device)
    like = base_kernel._leaf_like()
    base = dataclasses.replace(base_kernel, active_dims=tuple(range(input_dim)))
    coreg = Coregionalize.create(1, output_dim=num_outputs, rank=rank, W=W, kappa=kappa,
                                 active_dims=(input_dim,), dtype=like.dtype, device=like.device)
    return base * coreg


def lcm_kernel(input_dim, num_outputs, base_kernels, rank=1):
    """Sum of ICM terms, one per base kernel (GPy util/multioutput.LCM:62)."""
    out = None
    for k in base_kernels:
        part = icm_kernel(input_dim, num_outputs, base_kernel=k, rank=rank)
        out = part if out is None else out + part
    return out


def private_kernel(input_dim, num_outputs, base_kernel=None, output=0, kappa=1.0,
                   dtype=None, device=None):
    """An ICM term on one output only: W = 0 and kappa one-hot at ``output``
    (GPy util/multioutput.Private:82). Pass ``fix=("W", "kappa")`` to the
    fitter to keep it private."""
    kap = np.zeros((num_outputs,))
    kap[output] = float(kappa)
    return icm_kernel(input_dim, num_outputs, base_kernel=base_kernel, rank=1,
                      W=np.zeros((num_outputs, 1)), kappa=kap, dtype=dtype, device=device)


def _task_rows(Xnew, task, like):
    Xnew = np.atleast_2d(np.asarray(Xnew, dtype=float))
    Xa = np.hstack([Xnew, np.full((len(Xnew), 1), float(task))])
    return torch.as_tensor(Xa, dtype=like.dtype, device=like.device)


class GPCoregionalizedRegression:
    """One GP over the stacked data with an ICM kernel
    (gp_coregionalized_regression.py); ``predict(X, task)``. ``device`` None
    means the card."""

    def __init__(self, X_list, Y_list, base_kernel=None, rank=1, noise_var=0.1, dtype=None,
                 device=None):
        where = placement(dtype, device)
        X, Y = build_stacked_XY(X_list, Y_list)
        self.num_outputs = len(X_list)
        self.input_dim = X.shape[1] - 1
        if base_kernel is None:
            base_kernel = RBF.create(self.input_dim, **where)
        kern = icm_kernel(self.input_dim, self.num_outputs, base_kernel, rank=rank)
        self.model = GPRegression.create(X, Y, kernel=kern, noise_var=noise_var, **where)

    @classmethod
    def from_model(cls, model: GPRegression, num_outputs: int) -> "GPCoregionalizedRegression":
        out = cls.__new__(cls)
        out.model, out.num_outputs = model, num_outputs
        out.input_dim = model.X.shape[-1] - 1
        return out

    def optimize(self, num_restarts=3, maxiter=300, generator=None, **kw):
        self.model, info = fit_module.fit(self.model, num_restarts=num_restarts,
                                          maxiter=maxiter, generator=generator, **kw)
        return info

    def log_marginal_likelihood(self):
        return self.model.log_marginal_likelihood()

    def predict(self, Xnew, task, posterior=None):
        return self.model.predict(_task_rows(Xnew, task, self.model.X), posterior=posterior)


class SparseGPCoregionalizedRegression:
    """Sparse (VarDTC) coregionalized regression
    (sparse_gp_coregionalized_regression.py:10): stacked data, an ICM kernel
    and inducing inputs stacked per output with a task column. The rounded
    task column has an exactly-zero gradient, so fitting leaves the inducing
    task column on its integers (the reference fixes it, :66)."""

    def __init__(self, X_list, Y_list, Z_list=None, base_kernel=None, rank=1, num_inducing=10,
                 noise_var=0.1, inference="vardtc", seed=0, dtype=None, device=None):
        where = placement(dtype, device)
        X, Y = build_stacked_XY(X_list, Y_list)
        self.num_outputs = len(X_list)
        self.input_dim = X.shape[1] - 1
        if base_kernel is None:
            base_kernel = RBF.create(self.input_dim, **where)
        kern = icm_kernel(self.input_dim, self.num_outputs, base_kernel, rank=rank)
        if Z_list is None:
            rng = np.random.default_rng(seed)
            if np.isscalar(num_inducing):
                num_inducing = [int(num_inducing)] * self.num_outputs
            Z_list = []
            for ni, Xi in zip(num_inducing, X_list):
                Xi = np.atleast_2d(np.asarray(Xi, dtype=float))
                idx = rng.permutation(len(Xi))[:min(ni, len(Xi))]
                Z_list.append(Xi[idx].copy())
        else:
            assert len(Z_list) == self.num_outputs, (
                "Number of outputs does not match length of inducing list")
        Z, _ = build_stacked_XY(Z_list, [np.zeros((len(z), 1)) for z in Z_list])
        self.model = SparseGPRegression.create(X, Y, kernel=kern, Z=Z, noise_var=noise_var,
                                               inference=inference, **where)

    def optimize(self, num_restarts=1, maxiter=300, generator=None, **kw):
        self.model, info = fit_module.fit(self.model, num_restarts=num_restarts,
                                          maxiter=maxiter, generator=generator, **kw)
        return info

    def log_marginal_likelihood(self):
        return self.model.log_marginal_likelihood()

    def predict(self, Xnew, task):
        return self.model.predict(_task_rows(Xnew, task, self.model.X))


class SparseGPRegressionMD:
    """Missing-data sparse GP regression (sparse_gp_regression_md.py:13,
    vardtc_md.py): one column of observations, ``indexD[n]`` the output row n
    belongs to; the bound is the sum of per-output VarDTC bounds on one Kmm
    factorization, through a dense (N, P) one-hot output mask."""

    def __init__(self, X, Y, indexD, kernel=None, Z=None, num_inducing=10, noise_var=None,
                 seed=0, dtype=None, device=None):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        Y = np.asarray(Y, dtype=float).reshape(len(X), 1)
        indexD = np.asarray(indexD).astype(int).reshape(-1)
        assert len(indexD) == len(X)
        self.output_dim = int(indexD.max()) + 1
        self.indexD = indexD
        self.output_mask = np.zeros((len(X), self.output_dim))
        self.output_mask[np.arange(len(X)), indexD] = 1.0
        if noise_var is None:
            noise_var = float(np.var(Y) * 0.01)  # gpmodel-style default (:56)
        self.model = SparseGPRegression.create(X, self.output_mask * Y, kernel=kernel, Z=Z,
                                               num_inducing=num_inducing, noise_var=noise_var,
                                               seed=seed, dtype=dtype, device=device)

    def _mask(self):
        return torch.as_tensor(self.output_mask, dtype=self.model.X.dtype,
                               device=self.model.X.device)

    def log_marginal_likelihood(self):
        return self.model.missing_data_lml(self._mask())

    def optimize(self, num_restarts=1, maxiter=300, generator=None, starts=None):
        """Fit the missing-data bound's hyperparameters by L-BFGS from the
        model's own point and ``num_restarts - 1`` random starts (or the rows
        of ``starts``, the first being the model's own), each lane on its own;
        the best finite lane is kept if it beats the starting point."""
        packer = make_packer(self.model)
        mask = self._mask()
        model = self.model

        def lane(u):
            return -packer.unpack(u, reference=model).missing_data_lml(mask)

        def objective(U):
            return torch.stack([lane(u) for u in U])

        u0 = packer.pack(model).detach()
        if starts is None:
            if generator is None:
                generator = torch.Generator(device=u0.device).manual_seed(0)
            z = torch.randn((num_restarts - 1, u0.shape[0]), generator=generator,
                            dtype=u0.dtype, device=u0.device)
            starts = torch.cat([u0[None], packer.map_restart(z)])
        with torch.no_grad():
            best_u, best_f = u0, float(lane(u0))
        res = lbfgs.minimize(objective, starts, maxiter=maxiter)
        for x, f in zip(res.x, res.f.tolist()):
            if np.isfinite(f) and f < best_f:
                best_u, best_f = x, f
        self.model = packer.unpack(best_u, reference=model)
        return {"objective": best_f}

    def predict(self, Xnew, task, include_likelihood=True):
        """Output ``task``'s collapsed VarDTC posterior from that output's own
        rows (vardtc_md.py)."""
        m = self.model
        Xnew = torch.as_tensor(np.atleast_2d(np.asarray(Xnew, dtype=float)), dtype=m.X.dtype,
                               device=m.X.device)
        sigma2 = m.likelihood_variance + config.noise_jitter
        Lm, A, _, Yc, _ = m._factorize()
        w = self._mask()[:, task]
        Aw = A * w
        eye = torch.eye(m.Z.shape[-2], dtype=A.dtype, device=A.device)
        LB, _, _ = linalg.jitchol(eye + (Aw @ Aw.mT) / sigma2)
        c = linalg.solve_lower(LB, Aw @ (Yc[:, task] * w)[:, None]) / sigma2
        tmp = linalg.solve_lower(Lm, m.kern.K(m.Z, Xnew))
        tmp2 = linalg.solve_lower(LB, tmp)
        mu = tmp2.mT @ c
        var = (m.kern.Kdiag(Xnew) - torch.sum(torch.square(tmp), dim=-2)
               + torch.sum(torch.square(tmp2), dim=-2))
        if include_likelihood:
            var = var + m.likelihood_variance
        return mu, torch.clamp(var, min=1e-15)[:, None]

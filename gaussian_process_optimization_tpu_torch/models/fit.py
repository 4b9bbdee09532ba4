"""Hyperparameter fitting: multi-restart L-BFGS on the negative log marginal
likelihood (twin of ``gaussian_process_optimization_tpu/models/fit.py``).

The reference vmaps one L-BFGS program over its restarts; here the restarts
are the lane axis of one batched program (``ops/lbfgs.py``), and the model's
hyperparameters carry that axis through ``Packer.unpack``. Drawing the restart
starts is split from the solve, so a caller (or a test) can hand in its own.
Priors are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch

from ..ops import lbfgs
from .parameters import make_packer

# the reference Fitter's defaults (fit.py:64): L-BFGS memory, and line-search
# trials per step; every trial is a full batched forward (a Cholesky per lane),
# and a lane that cannot improve within MAX_LS trials freezes
HISTORY = 10
MAX_LS = 8


def make_objective(packer):
    """obj(U, model) = -LML of the model with packed parameters U; ``U (B, n)``
    gives one value per lane, ``(B,)``. Priors are not ported yet."""

    def obj(U, model):
        return -packer.unpack(U, reference=model).log_marginal_likelihood()

    return obj


class Fitter:
    """Multi-restart fit for one model structure (``Fitter``, fit.py:64).
    Restart 0 starts from the model's own parameters; the others from N(0, 1)
    draws routed through each transform's ``random_restart``. ``fix`` and
    ``transform_overrides`` go to :func:`make_packer`. The objective factors
    with the model's own ladder hint and policy (``GPRegression.jitter_hint``,
    ``jitter_greedy``)."""

    def __init__(self, template_model: Any, num_restarts: int = 5, maxiter: int = 1000,
                 tol: float = 1e-5, fix: tuple = (), transform_overrides: dict | None = None):
        self.packer = make_packer(template_model, fix=fix,
                                  transform_overrides=transform_overrides)
        self.num_restarts = num_restarts
        self.maxiter = maxiter
        self.tol = tol
        self.objective = make_objective(self.packer)

    def draw_starts(self, model, generator: torch.Generator | None = None) -> torch.Tensor:
        """``(num_restarts, n)`` unconstrained starts."""
        u0 = self.packer.pack(model).detach()
        if self.num_restarts == 1:
            return u0[None]
        if generator is None:
            generator = torch.Generator(device=u0.device).manual_seed(0)
        z = torch.randn((self.num_restarts - 1, u0.shape[0]), generator=generator,
                        dtype=u0.dtype, device=u0.device)
        return torch.cat([u0[None], self.packer.map_restart(z)])

    def solve(self, model, starts: torch.Tensor):
        """Run the lanes from ``starts``; returns ``(fitted model, LBFGSResult)``
        with the best finite lane's parameters."""
        res = lbfgs.minimize(lambda U: self.objective(U, model), starts,
                             maxiter=self.maxiter, tol=self.tol, history=HISTORY,
                             max_ls=MAX_LS, carry_graph=True)
        f = torch.where(torch.isfinite(res.f), res.f, torch.full_like(res.f, float("inf")))
        best = int(torch.argmin(f))
        return self.packer.unpack(res.x[best], reference=model), res

    def __call__(self, model, generator: torch.Generator | None = None):
        return self.solve(model, self.draw_starts(model, generator))

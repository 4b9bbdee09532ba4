"""Hyperparameter fitting: multi-restart L-BFGS on the negative log marginal
likelihood plus log prior (twin of ``gaussian_process_optimization_tpu/models/fit.py``).

The reference vmaps one L-BFGS program over its restarts; here the restarts
are the lane axis of one batched program (``ops/lbfgs.py``), and the model's
hyperparameters carry that axis through ``Packer.unpack``. Drawing the restart
starts is split from the solve, so a caller (or a test) can hand in its own.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..config import config
from ..ops import lbfgs
from ..utils.priors import Prior
from ..utils.profiling import host, spanned
from ..utils.tree import leaf_name, named_leaves
from .parameters import make_packer

# the reference Fitter's defaults (fit.py:64): L-BFGS memory, and line-search
# trials per step; every trial is a full batched forward (a Cholesky per lane),
# and a lane that cannot improve within MAX_LS trials freezes
HISTORY = 10
MAX_LS = 8


def make_objective(packer, priors: dict[str, Prior] | None = None, extra_loss=None):
    """obj(U, model) = -(LML + log prior - extra_loss) of the model with packed
    parameters U; ``U (B, n)`` gives one value per lane, ``(B,)``.

    ``priors`` maps a field name to a Prior on the constrained value (GPy
    core/model.py:101-127: objective = -logL - logPrior); the name is the
    leaf's last attribute name, so ``lengthscale`` reaches every part of a
    combination kernel. A priored leaf that is not fixed also gets its
    transform's log-Jacobian, so the density is the change-of-variables one in
    the optimizer's coordinates (GPy priorizable.py:57-65). ``extra_loss(m)``,
    one value per lane of the unpacked model, is added to the objective.
    ``obj.tail(m, lml)`` is the objective from a model's LML."""

    def log_prior(m):
        total = 0.0
        for (path, leaf), shape, t, fx in zip(named_leaves(m), packer.shapes,
                                              packer.transforms, packer.fixed):
            pr = priors.get(leaf_name(path))
            if pr is None:
                continue
            lanes = tuple(leaf.shape[:leaf.ndim - len(shape)])

            def per_lane(v):
                # an elementwise prior gives one term per entry, a prior on a
                # whole (N, Q) leaf (DGPLVMPrior) one per lane or per row
                return torch.sum(v.reshape(lanes + (-1,)), dim=-1)

            term = per_lane(pr.lnpdf(leaf))
            if not fx:
                term = term + per_lane(t.log_jacobian(leaf))
            total = total + term
        return total

    def tail(m, total):
        if priors:
            total = total + log_prior(m)
        if extra_loss is not None:
            total = total - extra_loss(m)
        return -total

    def obj(U, model):
        m = packer.unpack(U, reference=model)
        return tail(m, m.log_marginal_likelihood())

    obj.tail = tail
    return obj


def _ladder_objective(packer, obj):
    """``(U, hint, model) -> (objective, rung)``: each lane factors greedily
    from its own hint (``GPRegression.jitter_greedy``) and returns the rung it
    accepted, as a float32 aux (the reference's ``obj_aux``, fit.py:124-128)."""

    def obj_aux(U, hint, model):
        m = packer.unpack(U, reference=model)
        m = dataclasses.replace(m, jitter_hint=hint, jitter_greedy=True)
        lml, *_, rung = m._core()
        return obj.tail(m, lml), rung.to(torch.float32)

    return obj_aux


class Fitter:
    """Multi-restart fit for one model structure (``Fitter``, fit.py:64).
    Restart 0 starts from the model's own parameters; the others from N(0, 1)
    draws routed through each transform's ``random_restart``. ``fix`` and
    ``transform_overrides`` go to :func:`make_packer`, ``priors`` to
    :func:`make_objective`. The objective factors with the model's own ladder
    hint and policy (``GPRegression.jitter_hint``, ``jitter_greedy``). With a
    ``mesh`` (``parallel/sharded.Mesh``) the restart lanes are split across its
    shards, each block evaluated on its shard's device
    (``sharded.sharded_lanes``); ``num_restarts`` must then be a multiple of
    the axis size.

    The reference's line-search options, off by default: ``nonmonotone_eta``
    and ``grow_backtracked`` go to ``lbfgs.minimize`` (None reads
    ``config.ls_grow_backtracked``). ``thread_ladder`` (None reads
    ``GPO_THREAD_LADDER``; only for an exact ``GPRegression``) threads each
    lane's accepted ladder rung into its next trial as ``jitter_hint``, with
    ``jitter_greedy``, through the L-BFGS aux channel, starting from the
    model's own hint; a mesh passes the rungs through with the lanes.
    ``trace`` (the port's, for ``plot_optimizer``) records each lane's
    objective per step in the result's ``trace``. ``jit`` is taken and ignored:
    the port runs eagerly. The parameters keep the reference's order; ``mesh``
    and ``trace``, the port's own, are keyword-only."""

    def __init__(self, template_model: Any, num_restarts: int = 5, maxiter: int = 1000,
                 fix: tuple = (), transform_overrides: dict | None = None,
                 priors: dict[str, Prior] | None = None, tol: float = 1e-5,
                 history: int = HISTORY, jit: bool = True, max_ls: int = MAX_LS,
                 nonmonotone_eta: float = 0.0, grow_backtracked: float | None = None,
                 thread_ladder: bool | None = None, *, mesh=None, trace: bool = False):
        if mesh is not None and num_restarts % mesh.shape["data"]:
            raise ValueError(f"{num_restarts} restarts do not split over "
                             f"{mesh.shape['data']} shards")
        self.mesh = mesh
        self.packer = make_packer(template_model, fix=fix,
                                  transform_overrides=transform_overrides)
        self.num_restarts = num_restarts
        self.maxiter = maxiter
        self.tol = tol
        self.history = history
        self.max_ls = max_ls
        self.objective = make_objective(self.packer, priors=priors)
        self.nonmonotone_eta = nonmonotone_eta
        self.trace = trace
        self.grow_backtracked = (config.ls_grow_backtracked if grow_backtracked is None
                                 else grow_backtracked)
        if thread_ladder is None:
            thread_ladder = bool(os.environ.get("GPO_THREAD_LADDER", ""))
        if thread_ladder:
            from .gp import GPRegression

            thread_ladder = type(template_model) is GPRegression
        self.thread_ladder = bool(thread_ladder)
        self.evaluations = 0

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

    @spanned("fit.solve")
    def solve(self, model, starts: torch.Tensor):
        """Run the lanes from ``starts``; returns ``(fitted model, LBFGSResult)``
        with the best finite lane's parameters. ``evaluations`` counts the
        batched objective calls (one forward of every lane each)."""
        self.evaluations = 0
        aux0 = None
        if self.thread_ladder:
            obj = _ladder_objective(self.packer, self.objective)
            h0 = model.jitter_hint
            aux0 = (torch.zeros((), dtype=torch.float32, device=starts.device) if h0 is None
                    else h0.to(device=starts.device, dtype=torch.float32).reshape(()))
        else:
            obj = self.objective
        if self.mesh is None:
            def batched(U, *aux):
                return obj(U, *aux, model)
        else:
            from ..parallel import sharded

            batched = sharded.sharded_lanes(
                self.mesh, lambda U, m, *aux: obj(U, *aux, m),
                [sharded.place(model, d) for d in self.mesh.shards()])

        def objective(U, *aux):
            self.evaluations += 1
            return batched(U, *aux)

        res = lbfgs.minimize(objective, starts,
                             maxiter=self.maxiter, tol=self.tol, history=self.history,
                             max_ls=self.max_ls, carry_graph=True,
                             nonmonotone_eta=self.nonmonotone_eta,
                             grow_backtracked=self.grow_backtracked, aux0=aux0,
                             trace=self.trace)
        f = torch.where(torch.isfinite(res.f), res.f, torch.full_like(res.f, float("inf")))
        best = int(host(torch.argmin(f)))
        return self.packer.unpack(res.x[best], reference=model), res

    def __call__(self, model, generator: torch.Generator | None = None):
        return self.solve(model, self.draw_starts(model, generator))


def checkgrad(model, fix: tuple = (), transform_overrides: dict | None = None, priors=None,
              eps: float = 1e-4, rtol: float = 1e-3, atol: float = 1e-6,
              verbose: bool = False) -> bool:
    """paramz ``m.checkgrad()``: central finite differences of the packed
    objective against its autograd gradient, in the optimizer's coordinates."""
    packer = make_packer(model, fix=fix, transform_overrides=transform_overrides)
    obj = make_objective(packer, priors=priors)
    u0 = packer.pack(model).detach()
    u = u0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(obj(u[None], model)[0], u)
    g = g.cpu().numpy().astype(float)
    fd = np.zeros_like(g)
    with torch.no_grad():
        for i in range(u0.numel()):
            up, um = u0.clone(), u0.clone()
            up[i] += eps
            um[i] -= eps
            fd[i] = (float(obj(up[None], model)[0]) - float(obj(um[None], model)[0])) / (2 * eps)
    ok = bool(np.allclose(g, fd, rtol=rtol, atol=atol))
    if verbose or not ok:
        print("checkgrad: analytic", g, "numeric", fd)
    return ok


def fit(model, num_restarts: int = 5, maxiter: int = 1000,
        generator: torch.Generator | None = None, fix: tuple = (),
        transform_overrides: dict | None = None, priors: dict[str, Prior] | None = None,
        jit: bool = True, **kw):
    """One-shot fit (GPy ``m.optimize_restarts(...)``): ``(fitted, LBFGSResult)``.
    ``jit`` is ignored (the port runs eagerly); ``kw`` goes to :class:`Fitter`."""
    fitter = Fitter(model, num_restarts=num_restarts, maxiter=maxiter, fix=fix,
                    transform_overrides=transform_overrides, priors=priors, jit=jit, **kw)
    return fitter(model, generator)

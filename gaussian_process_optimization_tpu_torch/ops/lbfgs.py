"""L-BFGS with box constraints over a lane axis (twin of
``gaussian_process_optimization_tpu/ops/lbfgs.py`` ``_minimize``).

The reference writes L-BFGS as a ``lax.while_loop`` and ``vmap``s it over
restarts or anchors. A vmapped while loop updates a lane only while that lane's
own condition holds, so each lane's result is that of an unbatched run. Here
the lane axis is explicit: ``fun`` maps ``(B, n)`` to ``(B,)`` with lane ``b``
depending on row ``b`` only; every trial evaluates all lanes at once (as the
vmapped program does), and per-lane masks decide which lanes a step or a
line-search trial updates.

Gradients, two modes as in the reference:

- ``carry_graph=True`` (its ``carry_vjp``, the fit): each line-search trial
  keeps its autograd graph while some lane stops on it; after the search one
  backward per such trial, with the lanes that stopped there as
  ``grad_outputs``, gives each lane the gradient at its own accepted point.
  Trials no lane stopped on are freed at once.
- ``carry_graph=False`` (the acquisition): value-only trials, then one value
  and gradient at the accepted points.

Line search: backtracking Armijo with the noise-aware slack, safeguarded
quadratic interpolation and the warm-started first trial; a non-finite trial
just shrinks the step. Box constraints by gradient projection.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # best-seen iterate per lane
    f: torch.Tensor          # its objective
    num_iters: torch.Tensor
    converged: torch.Tensor  # stopped on the projected-gradient tolerance
    num_ls: torch.Tensor     # objective evaluations spent in line searches
    failed: torch.Tensor     # a line search failed at max_ls trials, or a bad start


def _two_loop(k, g, S, Ys, rho, gamma, m):
    """Per-lane two-loop recursion over each lane's ring of (s, y) pairs. The
    ring is gathered once into chronological order (position 0 the oldest), and
    a slot that holds no pair yet, or a rejected one, gets rho = 0, which makes
    its step of either loop the identity; the arithmetic on the valid slots is
    that of the reference's masked loops, in the same order."""
    n = g.shape[-1]
    pos = torch.arange(m, device=g.device)
    order = torch.remainder(k[:, None] - m + pos[None, :], m)
    Sc = torch.gather(S, 1, order[:, :, None].expand(-1, -1, n)).unbind(1)
    Yc = torch.gather(Ys, 1, order[:, :, None].expand(-1, -1, n)).unbind(1)
    rc = torch.gather(rho, 1, order)
    valid = (pos[None, :] >= (m - torch.clamp(k, max=m))[:, None]) & (rc > 0)
    rc = torch.where(valid, rc, torch.zeros_like(rc)).unbind(1)
    q = g
    a = [None] * m
    for j in reversed(range(m)):  # newest first
        a[j] = rc[j] * torch.sum(Sc[j] * q, dim=-1)
        q = q - a[j][:, None] * Yc[j]
    q = q * gamma[:, None]
    for j in range(m):  # oldest first
        b = rc[j] * torch.sum(Yc[j] * q, dim=-1)
        q = q + (a[j] - b)[:, None] * Sc[j]
    return -q


def minimize(fun: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
             lower=None, upper=None, maxiter: int = 1000, history: int = 10,
             tol: float = 1e-5, max_ls: int = 25, carry_graph: bool = True) -> LBFGSResult:
    """Minimize each lane of ``fun`` from the rows of ``x0 (B, n)`` (a 1-D
    ``x0`` is one lane). ``lower`` / ``upper`` broadcast to ``x0`` and turn on
    box projection. Arguments as the reference's ``lbfgs.minimize``."""
    single = x0.ndim == 1
    x0 = x0.detach()[None] if single else x0.detach()
    B, n = x0.shape
    m = history
    dtype, dev = x0.dtype, x0.device
    has_bounds = lower is not None or upper is not None
    lo = None if lower is None else torch.as_tensor(lower, dtype=dtype, device=dev).expand(B, n)
    hi = None if upper is None else torch.as_tensor(upper, dtype=dtype, device=dev).expand(B, n)
    eps = torch.finfo(dtype).eps
    c1 = 1e-4

    def proj(x):
        if lo is not None:
            x = torch.maximum(x, lo)
        if hi is not None:
            x = torch.minimum(x, hi)
        return x

    def proj_grad(x, g):
        return x - proj(x - g) if has_bounds else g

    def value_and_grad(x, lanes):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(xr)
            (g,) = torch.autograd.grad(f, xr, grad_outputs=lanes.to(dtype))
        return f.detach(), g

    x0 = proj(x0)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    f0, g0 = value_and_grad(x0, every)

    k = torch.zeros(B, dtype=torch.int64, device=dev)
    x, f, g = x0.clone(), f0.clone(), g0
    S = torch.zeros(B, m, n, dtype=dtype, device=dev)
    Ys = torch.zeros_like(S)
    rho = torch.zeros(B, m, dtype=dtype, device=dev)
    gamma = torch.ones(B, dtype=dtype, device=dev)
    xb, fb = x0.clone(), f0.clone()
    frozen = torch.zeros(B, dtype=torch.bool, device=dev)
    n_ls = torch.zeros(B, dtype=torch.int64, device=dev)
    t_init = torch.ones(B, dtype=dtype, device=dev)
    ls_failed = torch.zeros(B, dtype=torch.bool, device=dev)

    def line_search(d, active):
        """Per-lane Armijo search from (x, f, g) along d, for the active lanes.
        Lanes not searching are evaluated at their best-seen point (the values
        are discarded), so a frozen lane cannot make the batch's factorizations
        climb the jitter ladder."""
        slack = 10.0 * eps * (1.0 + torch.abs(f))
        md = torch.sum(g * d, dim=-1)

        def trial(t, searching):
            x_new = torch.where(searching[:, None], proj(x + t[:, None] * d), xb)
            if carry_graph:
                xr = x_new.detach().requires_grad_(True)
                with torch.enable_grad():
                    f_graph = fun(xr)
                f_new = f_graph.detach()
                handle = (xr, f_graph)
            else:
                with torch.no_grad():
                    f_new = fun(x_new)
                handle = None
            ok = torch.isfinite(f_new) & (
                f_new <= f + c1 * torch.sum(g * (x_new - x), dim=-1) + slack)
            return x_new, f_new, handle, ok

        t = t_init.clone()
        x_acc, f_acc, handle, ok = trial(t, active)
        ok = ok & active
        it = torch.zeros(B, dtype=torch.int64, device=dev)
        stops = []  # (graph handle, lanes that stopped on that trial)
        pending = active & ~ok
        stopped = active & ~pending
        if carry_graph and bool(stopped.any()):
            stops.append((handle, stopped))
        del handle
        while bool(pending.any()):
            denom = 2.0 * (f_acc - f - md * t)
            t_q = torch.where(denom > 0, -md * t * t / denom, 0.5 * t)
            t_q = torch.where(torch.isfinite(t_q), t_q, 0.5 * t)
            t_q = torch.minimum(torch.maximum(t_q, 0.1 * t), 0.5 * t)
            t = torch.where(pending, t_q, t)
            x_new, f_new, handle, ok_new = trial(t, pending)
            x_acc = torch.where(pending[:, None], x_new, x_acc)
            f_acc = torch.where(pending, f_new, f_acc)
            ok = torch.where(pending, ok_new, ok)
            it = it + pending.to(it.dtype)
            stopped = pending & (ok_new | (it >= max_ls))
            pending = pending & ~stopped
            if carry_graph and bool(stopped.any()):
                stops.append((handle, stopped))
            del handle
        if carry_graph:
            g_new = torch.zeros_like(g)
            while stops:
                (xr, f_graph), lanes = stops.pop(0)
                (gr,) = torch.autograd.grad(f_graph, xr, grad_outputs=lanes.to(dtype))
                g_new = torch.where(lanes[:, None], gr, g_new)
                del xr, f_graph, gr
        else:
            f_acc, g_new = value_and_grad(x_acc, active)
        return x_acc, f_acc, g_new, ok, it + 1, t

    while True:
        active = ~frozen & (k < maxiter)
        if not bool(active.any()):
            break
        d = _two_loop(k, g, S, Ys, rho, gamma, m)
        descent = torch.sum(g * d, dim=-1) < 0
        d = torch.where(descent[:, None], d, -g)
        # first iteration: raw gradient scaled to unit infinity-norm
        scale = torch.clamp(torch.max(torch.abs(d), dim=-1).values, min=1.0)
        d = torch.where((k == 0)[:, None], d / scale[:, None], d)
        x_new, f_new, g_new, ls_ok, n_trials, t_acc = line_search(d, active)

        def upd(new, old):
            mask = active.reshape((B,) + (1,) * (old.ndim - 1))
            return torch.where(mask, new, old)

        n_ls = upd(n_ls + n_trials, n_ls)
        # next first trial: grow the accepted step 4x after a clean first-trial
        # accept, 2x after a backtracked one, capped at 1; reset after a failure
        grow = torch.where(n_trials == 1, torch.full_like(t_acc, 4.0),
                           torch.full_like(t_acc, 2.0))
        t_init = upd(torch.where(ls_ok, torch.clamp(grow * t_acc, max=1.0),
                                 torch.ones_like(t_acc)), t_init)
        s = x_new - x
        y = g_new - g
        sy = torch.sum(s * y, dim=-1)
        good = sy > 1e-10 * torch.linalg.vector_norm(s, dim=-1) \
            * torch.linalg.vector_norm(y, dim=-1)
        slot = torch.remainder(k, m)
        lanes = torch.arange(B, device=dev)
        S_slot, Y_slot = S[lanes, slot], Ys[lanes, slot]
        S[lanes, slot] = upd(torch.where(good[:, None], s, S_slot * 0.0), S_slot)
        Ys[lanes, slot] = upd(torch.where(good[:, None], y, Y_slot * 0.0), Y_slot)
        rho[lanes, slot] = upd(torch.where(good, 1.0 / sy, torch.zeros_like(sy)),
                               rho[lanes, slot])
        gamma = upd(torch.where(good, sy / torch.sum(y * y, dim=-1), gamma), gamma)
        better = active & (f_new < fb)
        xb = torch.where(better[:, None], x_new, xb)
        fb = torch.where(better, f_new, fb)
        small = torch.max(torch.abs(proj_grad(x_new, g_new)), dim=-1).values < tol
        ls_failed = ls_failed | (active & ~ls_ok)
        frozen = frozen | (active & (small | ~ls_ok))
        x, f, g = upd(x_new, x), upd(f_new, f), upd(g_new, g)
        k = k + active.to(k.dtype)

    bad_start = ~torch.isfinite(f0)
    xb = torch.where(bad_start[:, None], x0, xb)
    fb = torch.where(bad_start, f0, fb)
    res = LBFGSResult(x=xb, f=fb, num_iters=k, converged=frozen & ~ls_failed & ~bad_start,
                      num_ls=n_ls, failed=ls_failed | bad_start)
    if single:
        res = LBFGSResult(*(v[0] for v in res))
    return res

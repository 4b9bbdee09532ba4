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

Options, each off by default as in the reference: ``trace`` records each
lane's objective per iteration; ``nonmonotone_eta`` tests each lane's Armijo
condition against its own Zhang-Hager average of past values;
``grow_backtracked`` sets the warm start's growth after a backtracked accept;
``aux0`` threads a per-lane aux tensor through the objective, each lane
receiving the aux of its own last accepted evaluation.
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
    # (B, maxiter + 1) objective per iteration, NaN past num_iters; only with
    # minimize(..., trace=True)
    trace: torch.Tensor = None
    # the aux of each lane's last accepted evaluation; only with aux0
    aux: torch.Tensor = None


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


def minimize(fun: Callable, x0: torch.Tensor, lower=None, upper=None, maxiter: int = 1000,
             history: int = 10, tol: float = 1e-5, max_ls: int = 25, carry_graph: bool = True,
             trace: bool = False, nonmonotone_eta: float = 0.0, grow_backtracked: float = 2.0,
             aux0=None) -> LBFGSResult:
    """Minimize each lane of ``fun`` from the rows of ``x0 (B, n)`` (a 1-D
    ``x0`` is one lane). ``lower`` / ``upper`` broadcast to ``x0`` and turn on
    box projection. Arguments as the reference's ``lbfgs.minimize``:

    - ``trace``: ``result.trace`` holds each lane's f0 and then the objective
      of each step, ``(B, maxiter + 1)``, NaN where the lane did not step;
    - ``nonmonotone_eta`` in [0, 1): Zhang-Hager acceptance, each lane against
      its weighted average C of past values (0: plain Armijo); the returned
      ``(x, f)`` is the best seen either way;
    - ``grow_backtracked``: the warm start's growth of the accepted step after
      a backtracked accept (4 after a first-trial accept, capped at 1); 1.0 is
      the hold policy;
    - ``aux0``: a per-lane tensor (its first axis the lanes; a scalar is
      broadcast to them). ``fun(X, aux)`` then returns ``(f, aux_out)`` with
      ``aux_out`` shaped as ``aux0``; every evaluation gets, in each lane, the
      aux of that lane's last accepted evaluation (the first gets ``aux0``),
      and ``result.aux`` holds the final one. The aux is not differentiated.
    """
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
    eta = float(nonmonotone_eta)
    has_aux = aux0 is not None
    if has_aux:
        aux0 = torch.as_tensor(aux0, device=dev)
        if single:
            aux0 = aux0[None]
        elif aux0.ndim == 0:
            aux0 = aux0.expand(B)
        elif aux0.shape[0] != B:
            raise ValueError(f"aux0 has {aux0.shape[0]} rows for {B} lanes")

    def rows(mask, new, old):
        """Per-lane select of a tensor whose first axis is the lanes."""
        return torch.where(mask.reshape((B,) + (1,) * (old.ndim - 1)), new, old)

    def call(x, aux):
        """``(f, aux_out)``; ``aux_out`` None without the aux channel."""
        if not has_aux:
            return fun(x), None
        f, aux_out = fun(x, aux)
        return f, aux_out.detach()

    def proj(x):
        if lo is not None:
            x = torch.maximum(x, lo)
        if hi is not None:
            x = torch.minimum(x, hi)
        return x

    def proj_grad(x, g):
        return x - proj(x - g) if has_bounds else g

    def value_and_grad(x, lanes, aux):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f, aux_out = call(xr, aux)
            (g,) = torch.autograd.grad(f, xr, grad_outputs=lanes.to(dtype))
        return f.detach(), g, aux_out

    x0 = proj(x0)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    f0, g0, aux = value_and_grad(x0, every, aux0)

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
    if eta > 0.0:  # Zhang-Hager reference value and weight, per lane
        C, Q = f0.clone(), torch.ones(B, dtype=dtype, device=dev)
    if trace:
        ftrace = torch.full((B, int(maxiter) + 1), float("nan"), dtype=dtype, device=dev)
        ftrace[:, 0] = f0

    def line_search(d, active, fref):
        """Per-lane Armijo search from (x, f, g) along d, for the active lanes,
        each accepting against its ``fref`` (f, or the Zhang-Hager C).
        Lanes not searching are evaluated at their best-seen point (the values
        are discarded), so a frozen lane cannot make the batch's factorizations
        climb the jitter ladder. Every trial gets each lane's aux as it was
        before the search; the accepted trial's aux_out follows the lane's
        accepted value."""
        slack = 10.0 * eps * (1.0 + torch.abs(fref))
        md = torch.sum(g * d, dim=-1)

        def trial(t, searching):
            x_new = torch.where(searching[:, None], proj(x + t[:, None] * d), xb)
            if carry_graph:
                xr = x_new.detach().requires_grad_(True)
                with torch.enable_grad():
                    f_graph, aux_new = call(xr, aux)
                f_new = f_graph.detach()
                handle = (xr, f_graph)
            else:
                with torch.no_grad():
                    f_new, aux_new = call(x_new, aux)
                handle = None
            ok = torch.isfinite(f_new) & (
                f_new <= fref + c1 * torch.sum(g * (x_new - x), dim=-1) + slack)
            return x_new, f_new, handle, ok, aux_new

        t = t_init.clone()
        x_acc, f_acc, handle, ok, aux_acc = trial(t, active)
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
            x_new, f_new, handle, ok_new, aux_new = trial(t, pending)
            x_acc = torch.where(pending[:, None], x_new, x_acc)
            f_acc = torch.where(pending, f_new, f_acc)
            if has_aux:
                aux_acc = rows(pending, aux_new, aux_acc)
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
            f_acc, g_new, aux_acc = value_and_grad(x_acc, active, aux)
        return x_acc, f_acc, g_new, ok, it + 1, t, aux_acc

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
        # C >= f by construction (Zhang & Hager lemma 1.1); the max guards
        # rounding. Without the option the reference is f itself.
        fref = torch.maximum(f, C) if eta > 0.0 else f
        x_new, f_new, g_new, ls_ok, n_trials, t_acc, aux_new = line_search(d, active, fref)

        def upd(new, old):
            return rows(active, new, old)

        n_ls = upd(n_ls + n_trials, n_ls)
        # next first trial: grow the accepted step 4x after a clean first-trial
        # accept, grow_backtracked after a backtracked one, capped at 1; reset
        # after a failure
        grow = torch.where(n_trials == 1, torch.full_like(t_acc, 4.0),
                           torch.full_like(t_acc, grow_backtracked))
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
        if eta > 0.0:
            Q_new = eta * Q + 1.0
            C = upd((eta * Q * C + f_new) / Q_new, C)
            Q = upd(Q_new, Q)
        if has_aux:
            aux = upd(aux_new, aux)
        if trace:  # column k + 1 of each stepping lane
            col = torch.clamp(k + 1, max=maxiter)[:, None]
            ftrace.scatter_(1, col, torch.where(active, f_new, ftrace.gather(1, col)[:, 0])[:, None])
        x, f, g = upd(x_new, x), upd(f_new, f), upd(g_new, g)
        k = k + active.to(k.dtype)

    bad_start = ~torch.isfinite(f0)
    xb = torch.where(bad_start[:, None], x0, xb)
    fb = torch.where(bad_start, f0, fb)
    res = LBFGSResult(x=xb, f=fb, num_iters=k, converged=frozen & ~ls_failed & ~bad_start,
                      num_ls=n_ls, failed=ls_failed | bad_start,
                      trace=ftrace if trace else None, aux=aux)
    if single:
        res = LBFGSResult(*(None if v is None else v[0] for v in res))
    return res

"""Markov chain Monte Carlo over model hyperparameters (twin of
``gaussian_process_optimization_tpu/models/hmc.py``; GPy inference/mcmc/hmc.py:7
``HMC``, :70 ``HMC_shortcut``, samplers.py:17 ``Metropolis_Hastings``).

Every sampler walks the packed, unconstrained parameter vector (``utils/packing``)
with an identity mass matrix. The reference's ``lax.scan`` / ``fori_loop`` chains
are Python loops over tensors here; each gradient of the potential comes from
``torch.autograd.grad`` through the model's LML. Draws come from a
``torch.Generator``; every sampler also takes them injected (``draws``), so a
chain can be held step by step against the reference's draws. The samplers
take their arguments in the reference's order, the generator in the place of
its ``key``: ``hmc_sample`` and ``hmc_shortcut_sample`` require it, as the
reference requires its key (``None`` draws from torch's default generator).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def value_and_grad(fn, u: torch.Tensor):
    """``(fn(u), d fn / du)``, both detached."""
    with torch.enable_grad():
        x = u.detach().requires_grad_(True)
        v = fn(x)
        (g,) = torch.autograd.grad(v, x)
    return v.detach(), g


def hmc_draws(num_samples: int, dim: int, generator: torch.Generator | None, like):
    """``(momenta (num_samples, dim), log_uniforms (num_samples,))``: one
    standard-normal momentum and one log accept uniform per step."""
    new = dict(generator=generator, dtype=like.dtype, device=like.device)
    return torch.randn((num_samples, dim), **new), torch.log(torch.rand((num_samples,), **new))


def hmc_sample(potential_fn, u0: torch.Tensor, generator: torch.Generator | None,
               num_samples: int, stepsize: float = 1e-1, leapfrog_steps: int = 20, *,
               draws=None):
    """Sample from exp(-potential) (hmc.py:31 ``sample``). Returns ``(samples
    (num_samples, dim), accept_rate)``; every step stores a sample, the accepted
    proposal or the state before it (hmc.py:41-58).

    ``potential_fn(u) -> scalar`` must be differentiable. The gradient at the
    end of one leapfrog step is the gradient at the start of the next, at the
    same ``u``, so it is computed once: ``leapfrog_steps`` LML value-and-gradient
    evaluations per sample, the same arithmetic as the reference's two per step.
    ``draws``, ``(momenta, log_uniforms)`` as :func:`hmc_draws` gives them, replace
    the generator's. A proposal that is not finite is never accepted."""
    u = u0.detach()
    momenta, log_u = draws if draws is not None else hmc_draws(
        num_samples, u.shape[0], generator, u)
    f, g = value_and_grad(potential_fn, u)
    samples, accepts = [], []
    for i in range(num_samples):
        p = momenta[i]
        H_old = f + 0.5 * torch.dot(p, p)
        u_new, p_new, f_new, g_new = u, p, f, g
        for _ in range(leapfrog_steps):
            p_new = p_new - 0.5 * stepsize * g_new
            u_new = u_new + stepsize * p_new
            f_new, g_new = value_and_grad(potential_fn, u_new)
            p_new = p_new - 0.5 * stepsize * g_new
        H_new = f_new + 0.5 * torch.dot(p_new, p_new)
        accept = (log_u[i] < torch.clamp(H_old - H_new, max=0.0)) \
            & torch.isfinite(u_new).all() & torch.isfinite(H_new)
        u = torch.where(accept, u_new, u)
        f = torch.where(accept, f_new, f)
        g = torch.where(accept, g_new, g)
        samples.append(u)
        accepts.append(accept)
    rate = torch.stack(accepts).to(u.dtype).mean()
    return torch.stack(samples), rate


def metropolis_hastings(logpost_fn, u0, generator: torch.Generator | None = None,
                        num_samples: int = 10000, burnin: int = 1000, thin: int = 10,
                        cov=None, tune: bool = True, tune_throughout: bool = False,
                        tune_interval: int = 400, *, draws=None):
    """Random-walk Metropolis-Hastings with Gelman et al. tuning (samplers.py:17-71):
    proposals N(u, cov scale^2), scale from 2.4 / sqrt(D); uphill moves always,
    downhill ones with probability exp(f' - f); every ``tune_interval`` steps
    (during burn-in, or always with ``tune_throughout``) the proposal covariance
    is re-estimated from the window's states and the scale multiplied by 1.1
    above a 0.25 accept rate, divided by 1.1 below 0.15. The reference's guard
    on the tuning (samplers.py:65) crashes on an empty chain; as in the JAX
    package, the covariance comes from the window's states, with a floor.

    ``logpost_fn(u) -> scalar`` is the log posterior over the packed vector.
    ``draws``, ``(normals (num_samples, D), log_uniforms (num_samples,))``, one
    proposal normal and one log accept uniform per step, replace the
    generator's. Returns ``(samples (num_kept, D), accept_rate, scale, cov)``."""
    u = torch.as_tensor(u0).detach()
    dim = u.shape[0]
    new = dict(dtype=u.dtype, device=u.device)
    cov = np.eye(dim) if cov is None else np.asarray(cov, dtype=float)
    scale = 2.4 / math.sqrt(dim)
    f = logpost_fn(u).detach()
    states = []
    it = 0
    while it < num_samples:
        window = min(tune_interval, num_samples - it)
        chol = torch.as_tensor(np.linalg.cholesky(cov + 1e-12 * np.eye(dim)) * scale, **new)
        if draws is not None:
            z, log_u = draws[0][it:it + window], draws[1][it:it + window]
        else:
            z = torch.randn((window, dim), generator=generator, **new)
            log_u = torch.log(torch.rand((window,), generator=generator, **new))
        accepted = 0
        for k in range(window):
            prop = u + chol @ z[k]
            fprop = logpost_fn(prop).detach()
            if bool(torch.isfinite(fprop)) and (bool(fprop > f) or bool(log_u[k] < fprop - f)):
                u, f = prop, fprop
                accepted += 1
            states.append(u.cpu().numpy())
        it += window
        if tune and (it <= burnin or tune_throughout):
            recent = np.asarray(states[-tune_interval:])
            if recent.shape[0] >= max(8, dim + 1):
                c = np.cov(recent.T).reshape(dim, dim)
                if np.all(np.isfinite(c)) and np.trace(c) > 1e-12:
                    cov = c
            rate = accepted / window
            if rate > 0.25:
                scale *= 1.1
            elif rate < 0.15:
                scale /= 1.1
    chain = np.asarray(states)
    kept = chain[burnin + 1::thin] if burnin + 1 < chain.shape[0] else chain[-1:]
    total_acc = float(np.mean([np.any(chain[i] != chain[i - 1])
                               for i in range(1, chain.shape[0])]))
    return torch.as_tensor(kept, **new), total_acc, scale, cov


def hmc_shortcut_sample(potential_fn, u0, generator: torch.Generator | None,
                        num_samples: int, stepsize_range=(1e-6, 1e-1), groupsize: int = 5,
                        Hstd_th=(1e-5, 3.0), leapfrog_steps: int = 20, *, draws=None):
    """HMC with the shortcut trajectory test of ``HMC_shortcut`` (hmc.py:70-173).

    Per sample: a log-uniform stepsize from ``stepsize_range`` (hmc.py:87), then
    leapfrog steps kept in a buffer centred on the start; once ``groupsize``
    states lie along the current arm, the std of their last ``groupsize`` H
    values must lie inside ``Hstd_th`` (hmc.py:165-170). The first failure
    reverses: back to the centre with the momentum negated, for the steps left
    (hmc.py:136-148), or, without room, onto the forward arm; the second stops
    on the state the leftover step count wraps onto (hmc.py:155-163). Then the
    Metropolis accept against the start's H. The buffer indices are clamped as
    the reference's gathers clamp them. ``draws``, ``(step_uniforms
    (num_samples,), momenta (num_samples, D), log_uniforms (num_samples,))``,
    replace the generator's: per sample the uniform that sets the stepsize, the
    momentum and the log accept uniform. Returns ``(samples, accept_rate)``."""
    u = torch.as_tensor(u0).detach()
    dim = u.shape[0]
    new = dict(generator=generator, dtype=u.dtype, device=u.device)
    log_lo, log_hi = math.log(stepsize_range[0]), math.log(stepsize_range[1])
    L = leapfrog_steps
    C, nbuf = L, 2 * L + 1

    def H_of(x, p):
        return potential_fn(x).detach() + 0.5 * torch.dot(p, p)

    def leapfrog_step(x, p, eps):
        p = p - 0.5 * eps * value_and_grad(potential_fn, x)[1]
        x = x + eps * p
        return x, p - 0.5 * eps * value_and_grad(potential_fn, x)[1]

    def at(i):
        return min(max(int(i), 0), nbuf - 1)

    def trajectory(x0, p0, eps):
        th_buf = torch.zeros((nbuf, dim), dtype=u.dtype, device=u.device)
        p_buf = torch.zeros_like(th_buf)
        H_buf = torch.full((nbuf,), float("inf"), dtype=u.dtype, device=u.device)
        th_buf[C], p_buf[C], H_buf[C] = x0, p0, H_of(x0, p0)
        x, p = x0, p0
        pos, i, rev_pos, done = 1, 0, 0, False
        fx, fp = x0, p0
        while i < L and not done:
            x, p = leapfrog_step(x, p, eps)
            slot = C + pos
            th_buf[slot], p_buf[slot], H_buf[slot] = x, p, H_of(x, p)
            i += 1
            reversed_ = rev_pos != 0
            have = rev_pos - pos + 1 if reversed_ else pos + 1
            start = C + pos if reversed_ else C + pos - groupsize + 1
            start = min(max(start, 0), nbuf - groupsize)
            hstd = float(torch.std(H_buf[start:start + groupsize], unbiased=False))
            ok = Hstd_th[0] <= hstd <= Hstd_th[1]
            fail = i >= groupsize and have >= groupsize and not ok
            first_fail = fail and not reversed_
            second_fail = fail and reversed_
            room = (L - i) > pos
            if second_fail:
                seg = (rev_pos - pos) * 2
                r = (L - i) % max(seg, 1) if seg > 0 else 0
                pos2 = 2 * rev_pos - r - pos if r > (rev_pos - pos) else pos + r
                x, p = th_buf[at(C + pos2)], p_buf[at(C + pos2)]
            elif first_fail and room:
                x, p = th_buf[C], -p_buf[C]
            elif first_fail:
                pos1 = pos - L + i
                x, p = th_buf[at(C + pos1)], -p_buf[at(C + pos1)]
            now_done = second_fail or (first_fail and not room)
            if now_done:
                fx, fp = x, p
            if first_fail and room:
                rev_pos, i, pos = pos, i - 1, -1
            else:
                pos = pos - 1 if reversed_ else pos + 1
            done = now_done
        return (fx, fp) if done else (x, p)

    samples, accepts = [], []
    for k in range(num_samples):
        if draws is not None:
            step_u, p, log_uniform = draws[0][k], draws[1][k], draws[2][k]
        else:
            step_u, p = torch.rand((), **new), torch.randn((dim,), **new)
            log_uniform = torch.log(torch.rand((), **new))
        eps = math.exp(log_lo + float(step_u) * (log_hi - log_lo))
        H_old = H_of(u, p)
        u_new, p_new = trajectory(u, p, eps)
        H_new = H_of(u_new, p_new)
        accept = bool(log_uniform < torch.clamp(H_old - H_new, max=0.0)) \
            and bool(torch.isfinite(u_new).all()) and bool(torch.isfinite(H_new))
        if accept:
            u = u_new
        samples.append(u)
        accepts.append(float(accept))
    return torch.stack(samples), float(np.mean(accepts))

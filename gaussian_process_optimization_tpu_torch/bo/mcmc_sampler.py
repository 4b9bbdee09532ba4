"""Affine-invariant ensemble sampler, Goodman and Weare's stretch moves (twin of
``gaussian_process_optimization_tpu/bo/mcmc_sampler.py``; GPyOpt
util/mcmc_sampler.py:31 ``AffineInvariantEnsembleSampler``, which entropy search
uses to draw representer points, acquisitions/ES.py:11).

The two half-ensembles move in turn, each half one batched call of the log
density. Draws come from a ``torch.Generator``, or are handed in
(:func:`ensemble_draws` gives their layout), so a chain can be held step by step
against the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype


@dataclasses.dataclass
class EnsembleDraws:
    """``init (W, d)`` walkers; per step and half-move ``(n_steps, 2, W - W // 2)``
    (a move of ``W // 2`` walkers reads the first ``W // 2``):
    ``u`` the stretch uniforms, ``partner`` the partner indices into the other
    half, ``log_u`` the log accept uniforms."""

    init: torch.Tensor
    u: torch.Tensor
    partner: torch.Tensor
    log_u: torch.Tensor


def ensemble_draws(lower, upper, n_walkers: int, n_steps: int,
                   generator: torch.Generator | None = None) -> EnsembleDraws:
    new = dict(generator=generator, dtype=lower.dtype, device=lower.device)
    half = n_walkers // 2
    width = n_walkers - half
    init = lower + (upper - lower) * torch.rand((n_walkers, lower.shape[0]), **new)
    u = torch.rand((n_steps, 2, width), **new)
    # the first half moves against the second (n_walkers - half walkers), and back
    partner = torch.stack([torch.randint(0, high, (n_steps, width), generator=generator,
                                         device=lower.device)
                           for high in (width, half)], dim=1)
    log_u = torch.log(torch.rand((n_steps, 2, width), **new))
    return EnsembleDraws(init=init, u=u, partner=partner, log_u=log_u)


def ensemble_sample(log_prob_fn, lower, upper, n_walkers: int, n_steps: int,
                    generator: torch.Generator | None = None, a: float = 2.0, init=None, *,
                    draws: EnsembleDraws | None = None):
    """Sample exp(log_prob) over the box [lower, upper]. ``log_prob_fn`` takes
    ``(n, d)`` and gives ``(n,)``; a proposal outside the box gets -inf, as the
    reference bounds its walkers to the domain. The walkers start at ``init``
    ``(n_walkers, d)`` where it is given, else at the draws' uniform ones; the
    draws are made all the same, so the moves do not depend on ``init``, as
    the reference's key split keeps them apart. Returns ``(chain (n_steps,
    n_walkers, d), final walkers)``."""
    d = lower.shape[0]
    if draws is None:
        draws = ensemble_draws(lower, upper, n_walkers, n_steps, generator)
    if init is not None:
        draws = dataclasses.replace(draws, init=torch.as_tensor(
            init, dtype=lower.dtype, device=lower.device))
    half = n_walkers // 2
    halves = (torch.arange(half, device=lower.device),
              torch.arange(half, n_walkers, device=lower.device))
    sqrt_a = float(np.sqrt(a))

    def bounded_log_prob(x):
        inside = torch.all((x >= lower) & (x <= upper), dim=-1)
        lp = log_prob_fn(x)
        return torch.where(inside, lp, torch.full_like(lp, -float("inf")))

    walkers = draws.init.clone()
    lp = bounded_log_prob(walkers)
    chain = []
    for step in range(n_steps):
        for h, (idx_move, idx_other) in enumerate((halves, halves[::-1])):
            u = draws.u[step, h, :idx_move.shape[0]]
            z = torch.square(u * (sqrt_a - 1.0 / sqrt_a) + 1.0 / sqrt_a)
            x_other = walkers[idx_other[draws.partner[step, h, :idx_move.shape[0]]]]
            x_move = walkers[idx_move]
            proposal = x_other + z[:, None] * (x_move - x_other)
            lp_prop = bounded_log_prob(proposal)
            log_accept = (d - 1) * torch.log(z) + lp_prop - lp[idx_move]
            accept = draws.log_u[step, h, :idx_move.shape[0]] < log_accept
            walkers = walkers.clone()
            walkers[idx_move] = torch.where(accept[:, None], proposal, x_move)
            lp = lp.clone()
            lp[idx_move] = torch.where(accept, lp_prop, lp[idx_move])
        chain.append(walkers)
    return torch.stack(chain), walkers


class AffineInvariantEnsembleSampler:
    """(util/mcmc_sampler.py:31): ``get_samples(n, log_p, burn_in_steps)``.
    ``device`` None means the card."""

    def __init__(self, space, seed=0, device=None, dtype=None):
        self.space = space
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def get_samples(self, n_samples, log_p_function, burn_in_steps=50):
        """``(samples (n_samples, d), log_p (n_samples, 1))`` as numpy, from
        ``max(2 d + 2, n_samples)`` walkers (rounded up to even) after
        ``burn_in_steps + 1`` steps; ``log_p_function`` takes numpy rows."""
        bounds = self.space.get_bounds()
        new = dict(dtype=self.dtype, device=self.device)
        lower = torch.as_tensor([b[0] for b in bounds], **new)
        upper = torch.as_tensor([b[1] for b in bounds], **new)
        n_walkers = max(2 * len(bounds) + 2, n_samples)
        n_walkers += n_walkers % 2

        def lp(x):
            v = np.asarray(log_p_function(x.cpu().numpy()), dtype=float).reshape(-1)
            return torch.as_tensor(v, **new)

        _, walkers = ensemble_sample(lp, lower, upper, n_walkers, burn_in_steps + 1,
                                     generator=self.generator)
        samples = walkers[:n_samples]
        return samples.cpu().numpy(), lp(samples).cpu().numpy().reshape(-1, 1)

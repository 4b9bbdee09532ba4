"""The bench's two workloads, through the port's own entry points.

The main path, one BO iteration as the JAX package's ``bench.py`` (``run_ours``)
defines it: a padded ``GPRegression`` with an ARD Matern52 kernel on the bench's
data recipe, a multi-restart L-BFGS fit of the negative LML, the posterior with
L^-1 precomputed, an EI sweep over random candidates, and box-bounded value-only
L-BFGS from the best few candidates. Candidates and restart starts can be handed
in.

The thesis path (``run_gower_lp``, bench.py:177-213): ``BayesianOptimization``
on 4 continuous and 2 discrete inputs with the Gower kernel, ``exact_feval``,
and a local-penalization batch of 5, one ``suggest_next_locations`` per
iteration (fit, Lipschitz estimate, 5 penalized argmaxes).

The sizes are arguments, so a test can run the same functions small.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bo.acquisitions import neg_ei
from .bo.methods import BayesianOptimization
from .config import resolve_device
from .kernels.stationary import Matern52
from .models.fit import Fitter
from .models.gp import GPRegression, Posterior
from .ops import lbfgs
from .ops.lbfgs import LBFGSResult

# bench.py:70-76
N = 4096
D = 6
FIT_RESTARTS = 5
FIT_STEPS = 30
ACQ_SWEEP = 1000
ACQ_ANCHORS = 5
ACQ_STEPS = 50
BOX = (-2.0, 2.0)
# bench.py:187-203
THESIS_BATCH = 5
THESIS_DOMAIN = (
    [{"name": f"x{i}", "type": "continuous", "domain": (-2.0, 2.0)} for i in range(4)]
    + [{"name": f"d{i}", "type": "discrete", "domain": (0, 1, 2)} for i in range(2)])


def bench_data(n: int = N, d: int = D, seed: int = 0):
    """The bench's data recipe (bench.py:79-84), numpy float64."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, size=(n, d))
    Y = np.sin(X[:, :1] * 2.0) + 0.3 * np.cos(X.sum(1, keepdims=True)) \
        + 0.05 * rng.standard_normal((n, 1))
    return X, Y


def make_model(X, Y, dtype=torch.float32, device=None) -> GPRegression:
    """The bench's padded ARD Matern52 GP; ``device`` None means the card."""
    device = resolve_device(device)
    d = X.shape[1]
    return GPRegression.create(
        X, Y, kernel=Matern52.create(d, ARD=True, dtype=dtype, device=device),
        noise_var=0.05, max_points=X.shape[0], dtype=dtype, device=device)


def fit(model: GPRegression, restarts: int = FIT_RESTARTS, steps: int = FIT_STEPS,
        starts: torch.Tensor | None = None, generator: torch.Generator | None = None):
    """``Fitter(restarts, maxiter=steps, tol=0.0)``; returns (fitted, LBFGSResult)."""
    fitter = Fitter(model, num_restarts=restarts, maxiter=steps, tol=0.0)
    if starts is None:
        starts = fitter.draw_starts(model, generator)
    return fitter.solve(model, starts)


@dataclasses.dataclass
class Acquisition:
    posterior: Posterior
    fmin: torch.Tensor
    candidates: torch.Tensor
    anchors: torch.Tensor
    result: LBFGSResult  # one lane per anchor
    x: torch.Tensor      # argmax of EI
    f: torch.Tensor      # its negative EI


def acquire(model: GPRegression, sweep: int = ACQ_SWEEP, anchors: int = ACQ_ANCHORS,
            steps: int = ACQ_STEPS, candidates: torch.Tensor | None = None,
            generator: torch.Generator | None = None) -> Acquisition:
    """EI argmax as bench.py:132-159: posterior with Li, fmin over the real
    rows, a candidate sweep, the ``anchors`` best candidates, and value-only
    box-bounded L-BFGS from each (one lane per anchor)."""
    X = model.X
    d = X.shape[1]
    post = model.inference(precompute_inverse=True)
    mu = model.predict(X, posterior=post)[0]
    fmin = torch.min(torch.where(model.mask[:, None] > 0, mu,
                                 torch.full_like(mu, float("inf"))))
    lo = torch.full((d,), BOX[0], dtype=X.dtype, device=X.device)
    hi = torch.full((d,), BOX[1], dtype=X.dtype, device=X.device)
    if candidates is None:
        u = torch.rand((sweep, d), generator=generator, dtype=X.dtype, device=X.device)
        candidates = lo + (hi - lo) * u
    scores = neg_ei(model, post, fmin, candidates)
    starts = candidates[torch.argsort(scores, stable=True)[:anchors]]
    res = lbfgs.minimize(lambda A: neg_ei(model, post, fmin, A[:, None, :])[:, 0],
                         starts, lower=lo, upper=hi, maxiter=steps, tol=0.0,
                         carry_graph=False)
    best = int(torch.argmin(res.f))
    return Acquisition(posterior=post, fmin=fmin, candidates=candidates, anchors=starts,
                       result=res, x=res.x[best], f=res.f[best])


def thesis_data(n: int = N, seed: int = 0):
    """The thesis recipe (bench.py:187-193), numpy float64: 4 continuous
    inputs in [-2, 2] and 2 discrete ones in {0, 1, 2}."""
    rng = np.random.default_rng(seed)
    Xc = rng.uniform(-2.0, 2.0, (n, 4))
    Xd = rng.integers(0, 3, (n, 2)).astype(float)
    X = np.hstack([Xc, Xd])
    Y = (np.sin(Xc[:, :1] * 2.0) + 0.3 * np.cos(Xc.sum(1, keepdims=True))
         + 0.1 * Xd[:, :1] + 0.05 * rng.standard_normal((n, 1)))
    return X, Y


def thesis_bo(X, Y, restarts: int = FIT_RESTARTS, steps: int = FIT_STEPS,
              batch: int = THESIS_BATCH, device=None,
              dtype=torch.float64) -> BayesianOptimization:
    """The bench's ask-tell optimizer (bench.py:198-203); ``device`` None
    means the card."""
    return BayesianOptimization(
        f=None, domain=THESIS_DOMAIN, X=X, Y=Y, Gower=True, acquisition_type="EI",
        evaluator_type="local_penalization", batch_size=batch, exact_feval=True, seed=0,
        max_iters=steps, optimize_restarts=restarts, device=resolve_device(device),
        dtype=dtype)


@dataclasses.dataclass
class ThesisIteration:
    batch: np.ndarray        # (batch, 6), objective space
    fit_s: float             # refit (multi-restart fit and posterior)
    estimate_L_s: float      # Lipschitz estimate
    argmax_s: list           # one per penalized argmax


def thesis_iteration(bo: BayesianOptimization) -> ThesisIteration:
    """One ``suggest_next_locations`` and its host-clock split. Each piece ends
    in a host read of its result, so its device work is inside its time."""
    batch = bo.suggest_next_locations()
    seconds = bo.evaluator.seconds
    return ThesisIteration(batch=batch, fit_s=bo.fit_seconds,
                           estimate_L_s=seconds["estimate_L"], argmax_s=seconds["argmax"])

"""Batch selection from a finite pool of configurations (twin of
``gaussian_process_optimization_tpu/bo/pool.py``): the reference application's
pattern (run.py:1234-1267 get_configurations). The acquisition is evaluated
over a pool of feasible configurations rather than optimized over the box, and
a local-penalization batch is built by re-scoring the penalized acquisition
over the pool after each pick, with the picked entries masked.

The scorer is the acquisition's own tensor code (``pure_neg_acq`` on
``device_args``), one call over the whole pool on the surrogate's device.
"""
from __future__ import annotations

import numpy as np
import torch

from .acquisitions import AcquisitionLP
from .evaluators import estimate_L


def score_pool(acquisition, pool_obj, space):
    """Acquisition values over a pool given in objective space, in the
    minimize convention (lower is better), infeasible entries +inf. Returns
    (scores, the pool in model space)."""
    Xm = space.unzip_inputs(pool_obj)
    gp, post, fmin, state = acquisition.device_args()
    with torch.no_grad():
        X = torch.as_tensor(np.asarray(Xm, dtype=float), dtype=gp.X.dtype, device=gp.X.device)
        scores = acquisition.pure_neg_acq(gp, post, fmin, state, X).cpu().numpy()
    scores = scores.astype(float)
    if space.has_constraints():
        ind = space.indicator_constraints(Xm).flatten()
        scores = np.where(ind == 1, scores, np.inf)
    return scores, Xm


def suggest_from_pool(acquisition, pool_obj, space, batch_size=1, exclude_mask=None):
    """Pick ``batch_size`` pool entries: the acquisition's argmax over the
    pool, then, for a local-penalization acquisition, the argmax of the
    penalized acquisition re-scored after each pick (run.py:1243-1263).
    Returns (indices, the picked rows in objective space)."""
    pool_obj = np.atleast_2d(np.asarray(pool_obj, dtype=float))
    n = pool_obj.shape[0]
    taken = (np.zeros(n, dtype=bool) if exclude_mask is None
             else np.asarray(exclude_mask, dtype=bool).copy())
    is_lp = isinstance(acquisition, AcquisitionLP)
    if is_lp:
        acquisition.update_batches(None, None, None)
    scores, Xm = score_pool(acquisition, pool_obj, space)
    picks = []
    L = Min = None
    for k in range(batch_size):
        s = np.where(taken, np.inf, scores)
        idx = int(np.argmin(s))
        if not np.isfinite(s[idx]):
            break
        picks.append(idx)
        taken[idx] = True
        if is_lp and k + 1 < batch_size:
            if L is None:
                L = estimate_L(acquisition.model, space.get_bounds())
                Min = acquisition.model.Y_min()
            acquisition.update_batches(Xm[picks], L, Min)
            scores, _ = score_pool(acquisition, pool_obj, space)
    if is_lp:
        acquisition.update_batches(None, None, None)
    return np.asarray(picks, dtype=int), pool_obj[picks]


def metamodel_rmse(model, X_test, Y_test):
    """RMSE of the surrogate's posterior mean against held-out values
    (run.py predict_using_metamodel:1322-1361). ``Y_test`` is in the model's
    training units: a BO loop's surrogate trains on 'stats'-normalized Y."""
    mu, _ = model.predict(np.atleast_2d(X_test))
    if isinstance(mu, torch.Tensor):
        mu = mu.detach().cpu().numpy()
    err = np.asarray(mu).flatten() - np.asarray(Y_test).flatten()
    return float(np.sqrt(np.mean(err ** 2)))


def shuffle_indices(X, variables, rng=None):
    """Relabel each discrete dimension's levels at random (run.py:192-205):
    the reference's test of whether BO reads a false order into discrete
    levels. ``variables`` is the domain list; ``rng`` a numpy Generator.
    Returns (a shuffled copy of X, the patterns); :func:`unshuffle_indices`
    inverts it."""
    rng = np.random.default_rng() if rng is None else rng
    X = np.array(X, dtype=float, copy=True)
    patterns = [None] * len(variables)
    for d, var in enumerate(variables):
        if var.get("type") != "discrete":
            continue
        levels = list(var["domain"])
        pattern = list(range(len(levels)))
        rng.shuffle(pattern)
        patterns[d] = pattern
        for row in X:
            row[d] = levels[pattern[levels.index(row[d])]]
    return X, patterns


def unshuffle_indices(X, variables, shuffle_patterns):
    """Invert :func:`shuffle_indices` (run.py:207-218)."""
    X = np.array(X, dtype=float, copy=True)
    for d, var in enumerate(variables):
        if var.get("type") != "discrete" or shuffle_patterns[d] is None:
            continue
        levels = list(var["domain"])
        pattern = shuffle_patterns[d]
        for row in X:
            row[d] = levels[pattern.index(levels.index(row[d]))]
    return X

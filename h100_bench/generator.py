"""The general generator: a configuration's data recipe and objective. The
data are the configuration's own; a run's seed orders the rows and draws the
noise of the rows told back, so every seed gets the same work."""
from __future__ import annotations

import numpy as np


def continuous_dims(cfg: dict) -> list[int]:
    return [i for i, v in enumerate(cfg["domain"]) if v["type"] == "continuous"]


def objective(cfg: dict, X: np.ndarray) -> np.ndarray:
    """The configuration's function without noise: a sin(2 x_0) + b cos(sum of
    the continuous inputs) + c (the first discrete input)."""
    f = cfg["function"]
    X = np.atleast_2d(X)
    cont = continuous_dims(cfg)
    out = f["sin_2x0"] * np.sin(2.0 * X[:, :1]) \
        + f["cos_sum_continuous"] * np.cos(X[:, cont].sum(1, keepdims=True))
    disc = [i for i in range(X.shape[1]) if i not in cont]
    if disc:
        out = out + f["first_discrete"] * X[:, disc[:1]]
    return out


def initial_data(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``rows`` points drawn uniformly over the domain (continuous inputs
    uniform in their interval, discrete ones uniform over their values) and
    their noisy values, from the configuration's fixed ``data_seed``; the
    run's ``seed`` orders the rows. Every seed so gets the same work, the GP
    being the same whatever the order of its rows."""
    rng = np.random.default_rng(cfg["data_seed"])
    n = cfg["rows"]
    cols = []
    for v in cfg["domain"]:
        if v["type"] == "continuous":
            cols.append(rng.uniform(v["domain"][0], v["domain"][-1], n))
        else:
            cols.append(rng.choice(np.asarray(v["domain"], dtype=float), n))
    X = np.stack(cols, axis=1)
    Y = objective(cfg, X) + cfg["noise_std"] * rng.standard_normal((n, 1))
    order = np.random.default_rng(seed).permutation(n)
    return X[order], Y[order]


def told_noise(seed: int) -> np.random.Generator:
    """The stream of observation noise for the rows told back in a run."""
    return np.random.default_rng([seed, 1])


def in_domain(cfg: dict, X: np.ndarray) -> np.ndarray:
    """Per row: every continuous input inside its interval and every discrete
    one on its grid."""
    ok = np.ones(len(X), dtype=bool)
    for j, v in enumerate(cfg["domain"]):
        col = X[:, j]
        if v["type"] == "continuous":
            ok &= (col >= v["domain"][0]) & (col <= v["domain"][-1])
        else:
            ok &= np.isin(col, np.asarray(v["domain"], dtype=float))
    return ok

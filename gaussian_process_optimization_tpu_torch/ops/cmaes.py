"""CMA-ES, host numpy: (mu/mu_w, lambda) covariance-matrix-adaptation ES (this
package's own copy of ``gaussian_process_optimization_tpu/ops/cmaes.py``).

GPyOpt's OptCma (optimization/optimizer.py:97) wraps the `cma` package; this is a
compact standard implementation (Hansen's tutorial defaults) for the acquisition
optimizer's 'CMA' mode: box handling by penalized resampling-free clipping.
"""
from __future__ import annotations

import numpy as np


def cma_minimize(f, x0, lower, upper, sigma0=0.3, max_evals=500, seed=0):
    """Minimize f over the box. f takes (n, d), returns (n,). Returns (x, fx)."""
    rng = np.random.default_rng(seed)
    lower = np.asarray(lower, dtype=float)
    upper = np.asarray(upper, dtype=float)
    span = upper - lower
    d = len(lower)

    # work in unit box
    m = (np.asarray(x0, dtype=float) - lower) / np.where(span > 0, span, 1.0)
    sigma = sigma0
    lam = 4 + int(3 * np.log(d))
    mu = lam // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w /= w.sum()
    mu_eff = 1.0 / np.sum(w**2)
    cc = (4 + mu_eff / d) / (d + 4 + 2 * mu_eff / d)
    cs = (mu_eff + 2) / (d + mu_eff + 5)
    c1 = 2 / ((d + 1.3) ** 2 + mu_eff)
    cmu = min(1 - c1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((d + 2) ** 2 + mu_eff))
    damps = 1 + 2 * max(0, np.sqrt((mu_eff - 1) / (d + 1)) - 1) + cs
    chiN = np.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

    pc = np.zeros(d)
    ps = np.zeros(d)
    C = np.eye(d)
    best_x, best_f = m.copy(), np.inf
    n_evals = 0
    gen = 0

    while n_evals < max_evals:
        gen += 1
        A = np.linalg.cholesky(C + 1e-12 * np.eye(d))
        Z = rng.standard_normal((lam, d))
        Xu = np.clip(m + sigma * Z @ A.T, 0.0, 1.0)
        vals = np.asarray(f(lower + Xu * span)).flatten()
        n_evals += lam
        order = np.argsort(vals)
        if vals[order[0]] < best_f:
            best_f = float(vals[order[0]])
            best_x = Xu[order[0]].copy()
        Xs = Xu[order[:mu]]
        Zs = Z[order[:mu]]
        m_old = m
        m = w @ Xs
        zmean = w @ Zs
        # conjugate path uses the WHITENED step (Hansen's invsqrtC*(m-m')/sigma
        # == an orthogonal transform of zmean): A @ zmean would scale ||ps||
        # with C's eigenvalues and bias the step-size/hsig control
        ps = (1 - cs) * ps + np.sqrt(cs * (2 - cs) * mu_eff) * zmean
        hsig = np.linalg.norm(ps) / np.sqrt(1 - (1 - cs) ** (2 * gen)) / chiN < 1.4 + 2 / (d + 1)
        pc = (1 - cc) * pc + hsig * np.sqrt(cc * (2 - cc) * mu_eff) * (m - m_old) / sigma
        artmp = (Xs - m_old) / sigma
        C = (
            (1 - c1 - cmu) * C
            + c1 * (np.outer(pc, pc) + (not hsig) * cc * (2 - cc) * C)
            + cmu * artmp.T @ np.diag(w) @ artmp
        )
        C = 0.5 * (C + C.T)
        sigma *= np.exp((cs / damps) * (np.linalg.norm(ps) / chiN - 1))
        sigma = float(np.clip(sigma, 1e-8, 1.0))

    return lower + best_x * span, best_f

"""DIRECT (DIviding RECTangles) global optimizer, host numpy (this package's own
copy of ``gaussian_process_optimization_tpu/ops/direct.py``).

GPyOpt's OptDirect (optimization/optimizer.py:64) wraps the DIRECT package; this is a
self-contained implementation of the classic Jones et al. algorithm (trisection of
potentially-optimal rectangles by the lower-convex-hull criterion), gradient-free,
for the acquisition optimizer's 'DIRECT' mode.
"""
from __future__ import annotations

import numpy as np


def direct_minimize(f, lower, upper, max_evals=300, eps=1e-4):
    """Minimize f over the box [lower, upper]. f takes (n, d) arrays, returns (n,).
    Returns (x_best, f_best)."""
    lower = np.asarray(lower, dtype=float)
    upper = np.asarray(upper, dtype=float)
    d = lower.shape[0]
    span = upper - lower

    def denorm(U):
        return lower + np.atleast_2d(U) * span

    # rectangle store: centers (unit), half side lengths per dim, f values
    centers = [np.full(d, 0.5)]
    sides = [np.full(d, 0.5)]
    fvals = [float(f(denorm(np.full(d, 0.5)))[0])]
    n_evals = 1

    while n_evals < max_evals:
        C = np.asarray(centers)
        S = np.asarray(sides)
        F = np.asarray(fvals)
        sizes = np.linalg.norm(S, axis=1)
        fmin = F.min()

        # potentially optimal: for each distinct size, the best rect; filter by
        # the epsilon lower-bound improvement condition
        # potentially optimal: best rectangle per distinct size, kept if it is
        # near the incumbent (epsilon condition) or is among the largest
        po = []
        for sz in np.unique(np.round(sizes, 12)):
            group = np.where(np.isclose(sizes, sz))[0]
            po.append(group[np.argmin(F[group])])
        po_final = [
            j for j in po
            if F[j] - eps * abs(fmin) <= fmin or np.isclose(sizes[j], sizes.max())
        ]
        if not po_final:
            po_final = [int(np.argmax(sizes))]

        new_centers, new_sides, new_fvals = [], [], []
        for j in po_final:
            c, s = C[j].copy(), S[j].copy()
            long_dims = np.where(np.isclose(s, s.max()))[0]
            delta = s.max() * 2.0 / 3.0
            # sample c +- delta e_i for each longest dim
            trials = []
            for i in long_dims:
                for sign in (+1, -1):
                    cc = c.copy()
                    cc[i] += sign * delta
                    trials.append((i, cc))
            if not trials:
                continue
            pts = np.asarray([t[1] for t in trials])
            vals = np.asarray(f(denorm(pts))).flatten()
            n_evals += len(trials)
            # divide: order dims by best value, shrink sides
            by_dim = {}
            for (i, cc), v in zip(trials, vals):
                by_dim.setdefault(i, []).append((v, cc))
            order = sorted(by_dim.keys(), key=lambda i: min(v for v, _ in by_dim[i]))
            s_cur = s.copy()
            for i in order:
                s_cur[i] /= 3.0
                for v, cc in by_dim[i]:
                    new_centers.append(cc)
                    new_sides.append(s_cur.copy())
                    new_fvals.append(float(v))
            centers[j] = c
            # fvals[j] unchanged (center retained with shrunk sides)
            sides[j] = s_cur.copy()
        centers.extend(new_centers)
        sides.extend(new_sides)
        fvals.extend(new_fvals)
        if n_evals >= max_evals:
            break

    F = np.asarray(fvals)
    j = int(np.argmin(F))
    return denorm(np.asarray(centers)[j])[0], float(F[j])

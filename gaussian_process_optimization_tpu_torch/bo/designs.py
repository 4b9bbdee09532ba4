"""Experiment designs (twin of ``gaussian_process_optimization_tpu/bo/designs.py``;
GPyOpt/GPyOpt/experiment_design/): random (constraint-rejection,
random_design.py:21), latin (LHS 'center' for continuous dims + random for the rest,
latin_design.py:8), latin_mixed (the reference author's new file,
latin_mixed_design.py:9 — stratified discrete levels with a representation check
>= floor(0.8 n/levels) and 10x-retry, maximin LHS for continuous), sobol
(sobol_design.py:8), grid (grid_design.py:8 with iroot), plus hammersley (used by the
reference application via chaospy, run.py generate_experimental_design:1007).

All host numpy and scipy.stats.qmc, in the arithmetic and the random-stream order of
the reference's numpy branch (the reference also has a native C++ engine for the
maximin searches and the Sobol points; this package has none).
"""
from __future__ import annotations

import numpy as np

from .variables import InvalidConfigError


def _rng(seed):
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def _fill_noncontinuous(space, samples, rng):
    """Random values for discrete/categorical/bandit columns (random_design.py:41)."""
    n = samples.shape[0]
    for v, osl in zip(space.space_expanded, space._objective_slices):
        if v.is_continuous:
            continue
        if v.is_bandit:
            idx = rng.integers(0, v.domain.shape[0], size=n)
            samples[:, osl] = v.domain[idx, :]
        else:
            vals = np.asarray(v.domain, dtype=float)
            samples[:, osl.start] = vals[rng.integers(0, len(vals), size=n)]


def _scale_to_bounds(unit, bounds):
    lo = np.asarray([b[0] for b in bounds], dtype=float)
    hi = np.asarray([b[1] for b in bounds], dtype=float)
    return lo + unit * (hi - lo)


def _lhs_unit(n, d, rng, criterion="center", iterations=20):
    """Latin hypercube in [0,1]^d. 'center': midpoints of stratified intervals
    (pyDOE lhs(criterion='center')); 'maximin': best of `iterations` random-centered
    designs by min pairwise distance (pyDOE criterion='maximin')."""

    def one(center=True):
        cut = np.linspace(0, 1, n + 1)
        lo, hi = cut[:-1], cut[1:]
        H = np.empty((n, d))
        for j in range(d):
            pts = (lo + hi) / 2 if center else rng.uniform(lo, hi)
            H[:, j] = rng.permutation(pts)
        return H

    if criterion == "center":
        return one(center=True)
    best, best_d = None, -np.inf
    for _ in range(iterations):
        Hc = one(center=False)
        dmin = np.min(
            np.linalg.norm(Hc[:, None, :] - Hc[None, :, :], axis=-1)
            + np.eye(n) * 1e9
        )
        if dmin > best_d:
            best, best_d = Hc, dmin
    return best


def random_design(space, n, seed=None):
    """Uniform random with constraint rejection (random_design.py:21-37)."""
    rng = _rng(seed)

    def batch(count):
        samples = np.empty((count, space.objective_dimensionality))
        _fill_noncontinuous(space, samples, rng)
        cdims = space.get_continuous_dims()
        if cdims:
            unit = rng.uniform(size=(count, len(cdims)))
            samples[:, cdims] = _scale_to_bounds(unit, space.get_continuous_bounds())
        return samples

    if not space.has_constraints():
        return batch(n)
    out = np.empty((0, space.objective_dimensionality))
    tries = 0
    while out.shape[0] < n:
        cand = batch(n)
        ok = (space.indicator_constraints(cand) == 1).flatten()
        out = np.vstack([out, cand[ok]])
        tries += 1
        if tries > 1000:
            raise RuntimeError("constraint rejection sampling failed (feasible region too small?)")
    return out[:n]


def latin_design(space, n, seed=None):
    """LHS 'center' on continuous dims, random elsewhere (latin_design.py:8)."""
    if space.has_constraints():
        raise InvalidConfigError("Sampling with constraints is not allowed by latin design")
    rng = _rng(seed)
    samples = np.empty((n, space.objective_dimensionality))
    _fill_noncontinuous(space, samples, rng)
    cdims = space.get_continuous_dims()
    if cdims:
        unit = _lhs_unit(n, len(cdims), rng, criterion="center")
        samples[:, cdims] = _scale_to_bounds(unit, space.get_continuous_bounds())
    return samples


def latin_mixed_design(space, n, seed=None, iterations=None, verbose=False):
    """The reference author's mixed-variable maximin LHS (latin_mixed_design.py:9).

    Discrete dims: stratified level assignment from an LHS grid, accepted only if each
    level appears at least floor(0.8 n / levels) times (when n >= levels), retried
    (10 outer retries x `iterations` inner candidates) maximizing min pairwise
    distance; continuous dims: maximin LHS.
    """
    if space.has_constraints():
        raise InvalidConfigError("Sampling with constraints is not allowed by latin design")
    rng = _rng(seed)
    samples = np.empty((n, space.objective_dimensionality))
    if iterations is None:
        iterations = min(30, 2 * n)

    ddims = space.get_discrete_dims()
    if ddims:
        discrete_values = space.get_discrete_values()

        def map_levels(H):
            out = np.zeros_like(H)
            for j, vals in enumerate(discrete_values):
                idx = (H[:, j] * len(vals)).astype(int)
                out[:, j] = np.asarray(vals, dtype=float)[np.clip(idx, 0, len(vals) - 1)]
            return out

        def representation_ok(H):
            M = map_levels(H)
            for j, vals in enumerate(discrete_values):
                levels = len(vals)
                if n < levels:
                    continue
                uniq, cnt = np.unique(M[:, j], return_counts=True)
                minimum = max(np.floor(0.8 * n / levels), 1)
                if cnt.min() < minimum or not np.all(
                    np.isin(np.asarray(vals, dtype=float), uniq)
                ):
                    return False
            return True

        H = None
        for _retry in range(10):
            maxdist = 0.0
            for _ in range(iterations):
                # stratified interval-start values, permuted per dim (:45-51)
                starts = np.linspace(0, 1, n, endpoint=False)
                Hc = np.stack([starts[rng.permutation(n)] for _ in ddims], axis=1)
                d = np.linalg.norm(Hc[:, None, :] - Hc[None, :, :], axis=-1)
                dmin = np.min(d + np.eye(n) * 1e9)
                if maxdist < dmin and representation_ok(Hc):
                    maxdist = dmin
                    H = Hc.copy()
            if H is not None:
                break
        if H is None:  # give up on representation, use the last candidate
            H = Hc
        samples[:, ddims] = map_levels(H)

    # categorical / bandit columns fall back to random fill
    for v, osl in zip(space.space_expanded, space._objective_slices):
        if v.is_categorical:
            vals = np.asarray(v.domain, dtype=float)
            samples[:, osl.start] = vals[rng.integers(0, len(vals), size=n)]
        elif v.is_bandit:
            idx = rng.integers(0, v.domain.shape[0], size=n)
            samples[:, osl] = v.domain[idx, :]

    cdims = space.get_continuous_dims()
    if cdims:
        unit = _lhs_unit(n, len(cdims), rng, criterion="maximin", iterations=iterations)
        samples[:, cdims] = _scale_to_bounds(unit, space.get_continuous_bounds())
    return samples


def _sobol_unit(n, d):
    """The first ``n`` points of the unscrambled Sobol sequence in [0, 1]^d.
    Unscrambled, the sequence draws nothing from a generator, so the engine is
    built without one: scipy renamed that argument (``seed`` before 1.15,
    ``rng`` from it), and a call that names neither runs on both."""
    import warnings

    from scipy.stats import qmc

    with warnings.catch_warnings():
        # n need not be a power of 2 for a design (GPyOpt calls
        # i4_sobol_generate the same way)
        warnings.simplefilter("ignore", UserWarning)
        return qmc.Sobol(d, scramble=False).random(n)


def sobol_design(space, n, seed=None):
    """Sobol sequence on continuous dims, random elsewhere (sobol_design.py:8)."""
    if space.has_constraints():
        raise InvalidConfigError("Sampling with constraints is not allowed by Sobol design")
    rng = _rng(seed)
    samples = np.empty((n, space.objective_dimensionality))
    _fill_noncontinuous(space, samples, rng)
    cdims = space.get_continuous_dims()
    if cdims:
        unit = _sobol_unit(n, len(cdims))
        samples[:, cdims] = _scale_to_bounds(unit, space.get_continuous_bounds())
    return samples


def _iroot(k, n):
    """Greatest x with x^k <= n (grid_design.py iroot)."""
    u, s = n, n + 1
    while u < s:
        s = u
        t = (k - 1) * s + n // pow(s, k - 1)
        u = t // k
    return s


def grid_design(space, n, seed=None):
    """Square grid on continuous dims (grid_design.py:8). May return fewer points:
    per-dim count = iroot(d, n)."""
    if space.has_constraints():
        raise InvalidConfigError("Sampling with constraints is not allowed by grid design")
    rng = _rng(seed)
    cdims = space.get_continuous_dims()
    per_dim = _iroot(len(cdims), n) if cdims else 1
    count = per_dim ** len(cdims) if cdims else n
    samples = np.empty((count, space.objective_dimensionality))
    _fill_noncontinuous(space, samples, rng)
    if cdims:
        bounds = space.get_continuous_bounds()
        axes = [np.linspace(b[0], b[1], per_dim) for b in bounds]
        mesh = np.meshgrid(*axes)
        grid = np.vstack([m.flatten(order="F") for m in mesh]).T
        samples[:, cdims] = grid
    return samples


def hammersley_design(space, n, seed=None):
    """Hammersley sequence on continuous dims (the reference application uses chaospy's
    Hammersley for its experimental design, run.py:1007-1072)."""
    rng = _rng(seed)
    samples = np.empty((n, space.objective_dimensionality))
    _fill_noncontinuous(space, samples, rng)
    cdims = space.get_continuous_dims()
    if cdims:
        d = len(cdims)

        def radical_inverse(i, base):
            inv, f = 0.0, 1.0 / base
            while i > 0:
                inv += f * (i % base)
                i //= base
                f /= base
            return inv

        primes = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61]
        unit = np.empty((n, d))
        unit[:, 0] = (np.arange(1, n + 1) - 0.5) / n
        for j in range(1, d):
            unit[:, j] = [radical_inverse(i, primes[j - 1]) for i in range(1, n + 1)]
        samples[:, cdims] = _scale_to_bounds(unit, space.get_continuous_bounds())
    return samples


_REGISTRY = {
    "random": random_design,
    "latin": latin_design,
    "latin_mixed": latin_mixed_design,
    "sobol": sobol_design,
    "grid": grid_design,
    "hammersley": hammersley_design,
}


def initial_design(design_name, space, init_points_count, seed=None, **kw):
    """Registry dispatch (experiment_design/__init__.py:8-22; 'latin_mixed' is the
    reference author's registration :18-19)."""
    if design_name not in _REGISTRY:
        raise ValueError(f"Unknown design type: {design_name}")
    return _REGISTRY[design_name](space, init_points_count, seed=seed, **kw)

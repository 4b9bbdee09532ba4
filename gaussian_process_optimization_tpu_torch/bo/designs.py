"""Experiment designs (twin of ``gaussian_process_optimization_tpu/bo/designs.py``;
GPyOpt/GPyOpt/experiment_design/), host numpy. Only the random design
(random_design.py:21) is ported: the anchor sweep of the acquisition optimizer
and the default initial design use it. The latin, latin_mixed, sobol, grid and
hammersley designs are not ported yet.
"""
from __future__ import annotations

import numpy as np


def _fill_noncontinuous(space, samples, rng):
    """Random values for discrete/categorical/bandit columns (random_design.py:41)."""
    n = samples.shape[0]
    for v, osl in zip(space.space_expanded, space._objective_slices):
        if v.is_continuous:
            continue
        if v.is_bandit:
            samples[:, osl] = v.domain[rng.integers(0, v.domain.shape[0], size=n), :]
        else:
            vals = np.asarray(v.domain, dtype=float)
            samples[:, osl.start] = vals[rng.integers(0, len(vals), size=n)]


def random_design(space, n, seed=None):
    """Uniform random with constraint rejection (random_design.py:21-37), in
    objective space. ``seed`` is an int or a ``numpy.random.Generator``."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)

    def batch(count):
        samples = np.empty((count, space.objective_dimensionality))
        _fill_noncontinuous(space, samples, rng)
        cdims = space.get_continuous_dims()
        if cdims:
            bounds = space.get_continuous_bounds()
            lo = np.asarray([b[0] for b in bounds], dtype=float)
            hi = np.asarray([b[1] for b in bounds], dtype=float)
            samples[:, cdims] = lo + rng.uniform(size=(count, len(cdims))) * (hi - lo)
        return samples

    if not space.has_constraints():
        return batch(n)
    out = np.empty((0, space.objective_dimensionality))
    tries = 0
    while out.shape[0] < n:
        cand = batch(n)
        out = np.vstack([out, cand[(space.indicator_constraints(cand) == 1).flatten()]])
        tries += 1
        if tries > 1000:
            raise RuntimeError("constraint rejection sampling failed (feasible region too small?)")
    return out[:n]


def initial_design(design_name, space, init_points_count, seed=None):
    """Registry dispatch (experiment_design/__init__.py:8-22)."""
    if design_name != "random":
        raise ValueError(f"design {design_name!r} is not ported; use 'random'")
    return random_design(space, init_points_count, seed=seed)

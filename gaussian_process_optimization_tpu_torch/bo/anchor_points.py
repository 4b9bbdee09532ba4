"""Anchor point generation for the acquisition optimizer (twin of
``gaussian_process_optimization_tpu/bo/anchor_points.py``;
GPyOpt/GPyOpt/optimization/anchor_points_generator.py:9), host numpy.

``get``: sample ``num_samples`` candidates from an experiment design, drop
duplicates, score them all in one call of the scorer, take the best
``num_anchor`` (:20-60).
"""
from __future__ import annotations

import numpy as np

from .designs import initial_design
from .variables import FullyExploredOptimizationDomainError


class AnchorPointsGenerator:
    def __init__(self, space, design_type, num_samples):
        self.space = space
        self.design_type = design_type
        self.num_samples = num_samples

    def get_anchor_point_scores(self, X):
        raise NotImplementedError

    def get(self, num_anchor=5, duplicate_manager=None, unique=False,
            context_manager=None, seed=None):
        X = initial_design(self.design_type, self.space, self.num_samples, seed=seed)

        if unique and duplicate_manager:
            # X comes from initial_design = OBJECTIVE-space (zipped) rows, so the
            # zipped check is the right one. (The reference calls
            # is_unzipped_x_duplicate here, anchor_points_generator.py:34 — with
            # categorical variables that zips an already-zipped row, which
            # mis-slices; deliberate fix, caught by tests/test_bo_fuzz.py.)
            X = np.array([x for x in X if not duplicate_manager.is_zipped_x_duplicate(x)])
            if X.size == 0:
                raise FullyExploredOptimizationDomainError(
                    "The whole search domain has been explored; cannot generate unique anchor points."
                )

        # scores are computed in MODEL space (the acquisition lives there)
        Xm = self.space.unzip_inputs(X)
        if context_manager is not None:
            Xm = context_manager.apply_context(Xm)
        scores = np.asarray(self.get_anchor_point_scores(Xm)).flatten()
        anchor_points = Xm[np.argsort(scores)[:min(len(scores), num_anchor)], :]
        return anchor_points


class ObjectiveAnchorPointsGenerator(AnchorPointsGenerator):
    """Score = objective f (the acquisition, minimize-convention); default 1000
    random samples (anchor_points_generator.py:87-99)."""

    def __init__(self, space, design_type, objective, num_samples=1000):
        super().__init__(space, design_type, num_samples)
        self.objective = objective

    def get_anchor_point_scores(self, X):
        return self.objective(X).flatten()


class ThompsonSamplingAnchorPointsGenerator(AnchorPointsGenerator):
    """Scores ~ N(mu(x), sigma(x)) per point, default 25000 sobol samples
    (anchor_points_generator.py:66-86)."""

    def __init__(self, space, design_type, model, num_samples=25000, seed=0):
        super().__init__(space, design_type, num_samples)
        self.model = model
        self._rng = np.random.default_rng(seed)

    def get_anchor_point_scores(self, X):
        posterior_means, posterior_stds = self.model.predict(X)
        return (
            posterior_means + posterior_stds * self._rng.standard_normal(posterior_means.shape)
        ).flatten()


class RandomAnchorPointsGenerator(AnchorPointsGenerator):
    """Scores = arrival order (anchor_points_generator.py:101)."""

    def __init__(self, space, design_type="random", num_samples=1000):
        super().__init__(space, design_type, num_samples)

    def get_anchor_point_scores(self, X):
        return np.arange(X.shape[0])

"""Acquisition optimization (twin of ``gaussian_process_optimization_tpu/bo/optimizer.py``;
GPyOpt optimization/acquisition_optimizer.py:16 ``AcquisitionOptimizer``,
``ContextManager``:82, optimizer.py ``apply_optimizer``:130).

The reference's device path: a numpy-seeded random sweep of the space, the
best few sweep points as anchors, box-bounded L-BFGS from every anchor at once
(here the anchors are the lanes of one ``ops/lbfgs.minimize`` call, value and
gradient by autograd), then rounding to the mixed space, re-scoring, and the
de-duplicated minimum. Context variables are held by collapsing their bounds to
a point. The reference's scipy host path (``optimize_host``, for surrogates
without tensor code or with a cost model) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lbfgs
from .designs import initial_design
from .variables import FullyExploredOptimizationDomainError


class ContextManager:
    """Fix a subset of variables during acquisition optimization
    (acquisition_optimizer.py:82)."""

    def __init__(self, space, context=None):
        self.space = space
        self.context = context or {}
        self.context_index = []
        self.context_value = []
        for v, msl in zip(space.space_expanded, space._model_slices):
            if v.name in self.context:
                for j, val in enumerate(v.objective_to_model(self.context[v.name])):
                    self.context_index.append(msl.start + j)
                    self.context_value.append(float(val))

    def apply_context(self, X_model):
        X_model = np.array(np.atleast_2d(X_model), dtype=float, copy=True)
        if self.context_index:
            X_model[:, self.context_index] = np.asarray(self.context_value)
        return X_model


# the reference's defaults (AcquisitionOptimizer, optimizer.py:73)
SWEEP = 1000
ANCHORS = 5
MAXITER = 200


class AcquisitionOptimizer:
    """(acquisition_optimizer.py:16): a random sweep of ``SWEEP`` points,
    ``ANCHORS`` anchors, ``MAXITER`` L-BFGS steps. The sweep's seed starts at 0
    and steps by one per call."""

    def __init__(self, space):
        self.space = space
        self.context_manager = None
        self._seed = 0

    def optimize(self, acq, duplicate_manager=None):
        """(x_min (1, model_dim), fx_min (1, 1)) as numpy, like the reference (:45-79)."""
        space = self.space
        cm = self.context_manager
        gp, post, fmin, state = acq.device_args()

        def score(Xm):
            with torch.no_grad():
                X = torch.as_tensor(Xm, dtype=gp.X.dtype, device=gp.X.device)
                return acq.pure_neg_acq(gp, post, fmin, state, X).cpu().numpy()

        # 1) anchor sweep: sample, drop duplicates, score, best ANCHORS
        self._seed += 1
        X_obj = initial_design("random", space, SWEEP, seed=self._seed)
        if duplicate_manager:
            keep = [i for i, x in enumerate(X_obj)
                    if not duplicate_manager.is_zipped_x_duplicate(x)]
            if not keep:
                raise FullyExploredOptimizationDomainError(
                    "The whole search domain has been explored; no unique anchor points.")
            X_obj = X_obj[keep]
        Xm = space.unzip_inputs(X_obj)
        if cm is not None:
            Xm = cm.apply_context(Xm)
        scores = score(Xm)
        if space.has_constraints():
            scores = np.where(space.indicator_constraints(Xm).flatten() == 1, scores, np.inf)
        anchors = Xm[np.argsort(scores)[:ANCHORS]]

        # 2) box-bounded L-BFGS, one lane per anchor (context dims collapsed)
        bounds = space.get_bounds()
        lo = np.asarray([b[0] for b in bounds], dtype=float)
        hi = np.asarray([b[1] for b in bounds], dtype=float)
        if cm is not None and cm.context_index:
            lo[cm.context_index] = np.asarray(cm.context_value)
            hi[cm.context_index] = np.asarray(cm.context_value)

        def t(a):
            return torch.as_tensor(a, dtype=gp.X.dtype, device=gp.X.device)

        res = lbfgs.minimize(lambda A: acq.pure_neg_acq(gp, post, fmin, state, A),
                             t(anchors), lower=t(lo), upper=t(hi), maxiter=MAXITER,
                             carry_graph=False)
        xs = res.x.cpu().numpy()

        # 3) round, re-apply context, re-score, drop duplicates, select
        #    (optimizer.py:130-168 apply_optimizer); the anchors are the fallback
        candidates = []
        for x in xs:
            xr = space.round_optimum(x)[0]
            if cm is not None and cm.context_index:
                xr[cm.context_index] = np.asarray(cm.context_value)
            candidates.append(xr)
        C = np.vstack(candidates + list(anchors))
        fC = score(C)
        if space.has_constraints():
            fC = np.where(space.indicator_constraints(C).flatten() == 1, fC, np.inf)
        if duplicate_manager:
            dup = np.asarray([duplicate_manager.is_unzipped_x_duplicate(c) for c in C])
            if not np.all(dup):
                fC = np.where(dup, np.inf, fC)
        best = int(np.argmin(fC))
        return np.atleast_2d(C[best]), np.atleast_2d(fC[best])

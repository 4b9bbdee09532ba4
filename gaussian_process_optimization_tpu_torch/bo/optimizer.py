"""Acquisition optimization (twin of ``gaussian_process_optimization_tpu/bo/optimizer.py``;
GPyOpt optimization/acquisition_optimizer.py:16 ``AcquisitionOptimizer``,
``ContextManager``:82, optimizer.py ``OptLbfgs``:28, ``apply_optimizer``:130).

Two paths, chosen as the reference chooses (``optimize``):

- the device path (an ``acquisition`` with tensor state, optimizer ``'lbfgs'``,
  no evaluation cost): a sweep of the
  space by an experiment design, the best few sweep points as anchors,
  box-bounded L-BFGS from every anchor at once (the anchors are the lanes of
  one ``ops/lbfgs.minimize`` call, value and gradient by autograd), then
  rounding to the mixed space, re-scoring, and the de-duplicated minimum;
- the host path (``optimize_host``: ``'lbfgs_host'``, ``'DIRECT'``, ``'CMA'``,
  any optimizer when the acquisition carries a cost, or no ``acquisition``):
  GPyOpt's own flow on the functions the caller gives, the anchors scored by
  ``f`` and scipy L-BFGS-B (on ``f_df``, or on ``f`` alone with scipy's
  differences) or DIRECT or CMA-ES from each anchor, one point per call.

Context variables are held by collapsing their bounds to a point. With a
``mesh`` (``parallel/sharded.Mesh``) the device path shards the sweep's rows
and the anchor lanes over its ``'data'`` axis, each padded up to a multiple of
the axis size with copies of its first row (the padding is dropped after).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import lbfgs
from ..parallel import sharded
from ..utils.profiling import host, span
from .anchor_points import ObjectiveAnchorPointsGenerator
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
OPTIMIZERS = ("lbfgs", "lbfgs_host", "DIRECT", "CMA")


class AcquisitionOptimizer:
    """(acquisition_optimizer.py:16): a ``design_type`` sweep of ``num_samples``
    points, ``num_anchor`` anchors, ``maxiter`` L-BFGS steps. ``optimizer`` is
    'lbfgs' (the device path), 'lbfgs_host' (scipy L-BFGS-B on the host
    acquisition), 'DIRECT' or 'CMA'. The sweep's seed starts at ``seed`` and
    steps by one per call. ``mesh`` shards the device path. Other keyword
    arguments are taken and ignored, as in the reference."""

    def __init__(self, space, optimizer="lbfgs", model=None, design_type="random",
                 num_samples=SWEEP, num_anchor=ANCHORS, maxiter=MAXITER, seed=0, mesh=None,
                 **kwargs):
        if optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown acquisition optimizer {optimizer!r}; "
                             f"one of {OPTIMIZERS}")
        self.space = space
        self.optimizer_name = optimizer
        self.model = model
        self.design_type = design_type
        self.num_samples = num_samples
        self.num_anchor = num_anchor
        self.maxiter = maxiter
        self.context_manager = None
        self._seed = seed
        self.mesh = sharded.check_mesh(mesh)

    def optimize(self, f=None, df=None, f_df=None, duplicate_manager=None,
                 acquisition=None):
        """(x_min (1, model_dim), fx_min (1, 1)) as numpy (:45-79): the device
        path for an ``acquisition`` with tensor state under 'lbfgs' without a
        cost, else the host path on ``f`` and ``f_df`` (``df`` is unused, as
        in the reference)."""
        if (acquisition is not None and acquisition.supports_device
                and self.optimizer_name == "lbfgs" and not acquisition.has_cost):
            return self._optimize_device(acquisition, duplicate_manager)
        return self.optimize_host(f=f, df=df, f_df=f_df, duplicate_manager=duplicate_manager)

    def _box(self):
        """The model-space box, context dimensions collapsed to their value."""
        bounds = self.space.get_bounds()
        lo = np.asarray([b[0] for b in bounds], dtype=float)
        hi = np.asarray([b[1] for b in bounds], dtype=float)
        cm = self.context_manager
        if cm is not None and cm.context_index:
            lo[cm.context_index] = np.asarray(cm.context_value)
            hi[cm.context_index] = np.asarray(cm.context_value)
        return lo, hi

    def _rounded(self, x):
        """A continuous optimum rounded to the mixed space, context re-applied."""
        cm = self.context_manager
        xr = self.space.round_optimum(x)[0]
        if cm is not None and cm.context_index:
            xr[cm.context_index] = np.asarray(cm.context_value)
        return xr

    @staticmethod
    def _select(C, fC, duplicate_manager):
        """The best candidate that is not a duplicate (optimizer.py:130-168)."""
        if duplicate_manager:
            dup = np.asarray([duplicate_manager.is_unzipped_x_duplicate(c) for c in C])
            if not np.all(dup):
                fC = np.where(dup, np.inf, fC)
        best = int(np.argmin(fC))
        return np.atleast_2d(C[best]), np.atleast_2d(fC[best])

    # ------------------------------------------------------------- device path
    def _optimize_device(self, acq, duplicate_manager):
        space = self.space
        cm = self.context_manager
        gp, post, fmin, state = acq.device_args()
        args = (gp, post, fmin, state)

        def neg_acq(A, a):
            return acq.pure_neg_acq(*a, A)

        def t(a):
            return torch.as_tensor(a, dtype=gp.X.dtype, device=gp.X.device)

        if self.mesh is not None:
            sweep = sharded.make_sharded_sweep(lambda a, A: neg_acq(A, a), self.mesh)

        def score(Xm):
            with torch.no_grad():
                if self.mesh is None:
                    return host(neg_acq(t(Xm), args)).numpy()
                Xp, n = self._pad_rows(Xm)
                return host(sweep(args, t(Xp))[:n]).numpy()

        # 1) anchor sweep: sample, drop duplicates, score, best num_anchor
        with span("acq.sweep"):
            self._seed += 1
            X_obj = initial_design(self.design_type, space, self.num_samples, seed=self._seed)
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
            anchors = Xm[np.argsort(scores)[:self.num_anchor]]

        # 2) box-bounded L-BFGS, one lane per anchor (context dims collapsed);
        #    an acquisition without gradients (entropy search's argmin counts)
        #    keeps its anchors: the sweep covers the box
        lo, hi = self._box()
        xs = anchors
        if acq.analytical_gradient_prediction:
            fun = lambda A: neg_acq(A, args)  # noqa: E731
            starts, n = anchors, anchors.shape[0]
            if self.mesh is not None:
                fun = sharded.sharded_lanes(
                    self.mesh, neg_acq, [sharded.place(args, d) for d in self.mesh.shards()])
                starts, n = self._pad_rows(anchors)
            with span("acq.lbfgs"):
                res = lbfgs.minimize(fun, t(starts), lower=t(lo), upper=t(hi),
                                     maxiter=self.maxiter, carry_graph=False)
                xs = host(res.x[:n]).numpy()

        # 3) round, re-apply context, re-score, drop duplicates, select; the
        #    anchors are the fallback
        with span("acq.select"):
            C = np.vstack([self._rounded(x) for x in xs] + list(anchors))
            fC = score(C)
            if space.has_constraints():
                fC = np.where(space.indicator_constraints(C).flatten() == 1, fC, np.inf)
            return self._select(C, fC, duplicate_manager)

    def _pad_rows(self, X):
        """``(X padded with copies of its first row up to a multiple of the
        mesh's 'data' axis, the real row count)``."""
        n = X.shape[0]
        n_pad = -(-n // self.mesh.shape["data"]) * self.mesh.shape["data"]
        return np.vstack([X, np.repeat(X[:1], n_pad - n, axis=0)]), n

    # ------------------------------------------------------------- host path
    def optimize_host(self, f=None, df=None, f_df=None, duplicate_manager=None):
        """GPyOpt's own path: anchors scored by ``f``, then from each anchor
        scipy L-BFGS-B (optimizer.py OptLbfgs:28), DIRECT (OptDirect:64, run
        once: it does not start from an anchor) or CMA-ES (OptCma:97), and
        ``apply_optimizer``:130. ``f`` and ``f_df`` take ``(n, d)`` numpy
        arrays; without ``f_df`` scipy differences ``f``. ``df`` is unused, as
        in the reference."""
        import scipy.optimize

        anchor_gen = ObjectiveAnchorPointsGenerator(
            self.space, self.design_type, f, num_samples=self.num_samples)
        self._seed += 1
        anchors = anchor_gen.get(
            num_anchor=self.num_anchor, duplicate_manager=duplicate_manager,
            unique=bool(duplicate_manager), context_manager=self.context_manager,
            seed=self._seed)
        lo, hi = self._box()
        box = list(zip(lo, hi))
        max_evals = min(4 * self.maxiter, 1000)

        def flat(X):
            return np.asarray(f(X)).flatten()

        if self.optimizer_name == "DIRECT":
            anchors = anchors[:1]
        candidates = []
        for a in anchors:
            if self.optimizer_name == "DIRECT":
                from ..ops.direct import direct_minimize

                x, _ = direct_minimize(flat, lo, hi, max_evals=max_evals)
            elif self.optimizer_name == "CMA":
                from ..ops.cmaes import cma_minimize

                x, _ = cma_minimize(flat, a, lo, hi, max_evals=max_evals)
            else:
                if f_df is not None:
                    def func(x):
                        fx, dfx = f_df(np.atleast_2d(x))
                        return np.asarray(fx).flatten()[0], np.asarray(dfx).flatten()
                else:
                    def func(x):
                        return float(flat(np.atleast_2d(x))[0])
                res = scipy.optimize.minimize(func, a, method="L-BFGS-B",
                                              jac=f_df is not None, bounds=box,
                                              options={"maxiter": self.maxiter})
                # scipy's ABNORMAL_TERMINATION: keep the anchor (optimizer.py:54-56)
                x = res.x if np.isfinite(res.fun) else a
            candidates.append(self._rounded(x))
        C = np.vstack(candidates + list(anchors))
        return self._select(C, flat(C), duplicate_manager)

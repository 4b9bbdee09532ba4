"""Batch evaluators (twin of ``gaussian_process_optimization_tpu/bo/evaluators.py``;
GPyOpt core/evaluators/: base.py:7 ``EvaluatorBase`` and
``SamplingBasedBatchEvaluator``:21, sequential.py:7, batch_random.py:9,
batch_thompson.py:10, batch_local_penalization.py:9 with estimate_L:52).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..ops import lbfgs
from ..utils.profiling import host, span
from .acquisitions import AcquisitionLP
from .anchor_points import RandomAnchorPointsGenerator, ThompsonSamplingAnchorPointsGenerator


class EvaluatorBase:
    """(base.py:7)"""

    def __init__(self, acquisition, batch_size, **kwargs):
        self.acquisition = acquisition
        self.batch_size = batch_size

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        raise NotImplementedError


class Sequential(EvaluatorBase):
    """One acquisition argmax per batch (sequential.py:7)."""

    def __init__(self, acquisition, batch_size=1):
        super().__init__(acquisition, batch_size)

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        x, _ = self.acquisition.optimize(duplicate_manager=duplicate_manager)
        return x


class SamplingBasedBatchEvaluator(EvaluatorBase):
    """(base.py:21): a batch built from anchor points, with the de-duplication
    loop of compute_batch:46."""

    def __init__(self, acquisition, batch_size, **kwargs):
        super().__init__(acquisition, batch_size)
        self.space = acquisition.space
        self.num_anchor = 5 * batch_size

    def initialize_batch(self, duplicate_manager=None, context_manager=None):
        raise NotImplementedError

    def get_anchor_points(self, duplicate_manager=None, context_manager=None):
        raise NotImplementedError

    def optimize_anchor_point(self, a, duplicate_manager=None, context_manager=None):
        raise NotImplementedError

    def compute_batch_without_duplicate_logic(self, context_manager=None):
        raise NotImplementedError

    def zip_and_tuple(self, x):
        return tuple(self.space.zip_inputs(np.atleast_2d(x)).flatten())

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        self.context_manager = context_manager
        if not duplicate_manager:
            return self.compute_batch_without_duplicate_logic(context_manager=context_manager)

        batch, already = [], duplicate_manager.unique_points.copy()
        anchor_points = self.get_anchor_points(duplicate_manager, context_manager)
        x0 = self.initialize_batch(duplicate_manager, context_manager)
        if x0 is not None and np.any(x0):
            batch.append(x0)
            already.add(self.zip_and_tuple(x0))
        for a in anchor_points:
            x = self.optimize_anchor_point(a, duplicate_manager, context_manager)
            zx = self.zip_and_tuple(x)
            if zx not in already:
                batch.append(x)
                already.add(zx)
            else:
                za = self.zip_and_tuple(a)
                if za not in already:
                    batch.append(a)
                    already.add(za)
            if len(batch) == self.batch_size:
                break
        if len(batch) < self.batch_size:
            print(f"Warning: the batch of requested size {self.batch_size} could not be "
                  f"entirely filled in (only {len(batch)} points)")
        return np.vstack([np.atleast_2d(b) for b in batch])


class RandomBatch(SamplingBasedBatchEvaluator):
    """The first element by acquisition argmax, the rest uniformly random
    (batch_random.py:9)."""

    def initialize_batch(self, duplicate_manager=None, context_manager=None):
        x, _ = self.acquisition.optimize(duplicate_manager=duplicate_manager)
        return x

    def get_anchor_points(self, duplicate_manager=None, context_manager=None):
        gen = RandomAnchorPointsGenerator(self.space, "random")
        return gen.get(num_anchor=self.num_anchor, duplicate_manager=duplicate_manager,
                       unique=bool(duplicate_manager),
                       context_manager=self.acquisition.optimizer.context_manager)

    def optimize_anchor_point(self, a, duplicate_manager=None, context_manager=None):
        return a

    def compute_batch_without_duplicate_logic(self, context_manager=None):
        x = self.initialize_batch()
        anchors = self.get_anchor_points(context_manager=context_manager)
        return np.vstack((x, anchors[:(self.batch_size - 1), :]))


class ThompsonBatch(SamplingBasedBatchEvaluator):
    """Each element by optimizing the acquisition from a Thompson-sampled
    anchor (batch_thompson.py:10): the anchors are the best of 25000 random
    points under one draw N(mu(x), sigma(x)) per point, and each is polished
    by box-bounded L-BFGS on the acquisition (one lane of ``ops/lbfgs``)."""

    def __init__(self, acquisition, batch_size):
        super().__init__(acquisition, batch_size)
        self.model = acquisition.model

    def initialize_batch(self, duplicate_manager=None, context_manager=None):
        return None

    def get_anchor_points(self, duplicate_manager=None, context_manager=None):
        gen = ThompsonSamplingAnchorPointsGenerator(self.space, "random", model=self.model)
        return gen.get(num_anchor=self.num_anchor, duplicate_manager=duplicate_manager,
                       unique=bool(duplicate_manager), context_manager=context_manager)

    def optimize_anchor_point(self, a, duplicate_manager=None, context_manager=None):
        """L-BFGS from this anchor, then round (batch_thompson.py:40-52)."""
        acq = self.acquisition
        bounds = self.space.get_bounds()
        lo = np.asarray([b[0] for b in bounds], dtype=float)
        hi = np.asarray([b[1] for b in bounds], dtype=float)
        if context_manager is not None and context_manager.context_index:
            lo[context_manager.context_index] = np.asarray(context_manager.context_value)
            hi[context_manager.context_index] = np.asarray(context_manager.context_value)
        gp, post, fmin, state = acq.device_args()

        def t(v):
            return torch.as_tensor(v, dtype=gp.X.dtype, device=gp.X.device)

        res = lbfgs.minimize(lambda A: acq.pure_neg_acq(gp, post, fmin, state, A),
                             t(np.atleast_2d(a)), lower=t(lo), upper=t(hi),
                             maxiter=acq.optimizer.maxiter, carry_graph=False)
        return self.space.round_optimum(res.x[0].cpu().numpy())

    def compute_batch_without_duplicate_logic(self, context_manager=None):
        anchors = self.get_anchor_points(context_manager=context_manager)
        return np.vstack([self.optimize_anchor_point(a, context_manager=context_manager)
                          for a, _ in zip(anchors, range(self.batch_size))])


def _neg_grad_norm(gp, post, X):
    """-|grad mu(x)| of the posterior mean at each row of ``X (M, D)``, shape
    (M,). Each row's mean depends on that row alone, so one backward of the
    summed mean gives every row's gradient. Under grad mode the result stays
    differentiable in ``X`` (a double backward)."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        Xr = X if X.requires_grad else X.detach().requires_grad_(True)
        mu = gp.predict_mean(Xr, post)
        (g,) = torch.autograd.grad(mu.sum(), Xr, create_graph=outer)
    return -torch.sqrt(torch.sum(torch.square(g), dim=-1) + 1e-300)


def estimate_L(model, bounds, seed=0):
    """Lipschitz estimate of the posterior mean (batch_local_penalization.py:52-76):
    max |grad mu| over 500 uniform samples and the training inputs, refined by
    box-bounded L-BFGS (200 steps) from the best of them; L = 10 when it is
    below 1e-7 (a flat model). A surrogate without one posterior (the MCMC
    model's samples) gives its point-estimate model, factored here
    (evaluators.py:243-247)."""
    gp, post = model.model, getattr(model, "posterior", None)
    if post is None:
        with torch.no_grad():
            post = dataclasses.replace(gp, jitter_greedy=False).inference()
    lo = np.asarray([b[0] for b in bounds], dtype=float)
    hi = np.asarray([b[1] for b in bounds], dtype=float)
    rng = np.random.default_rng(seed)
    samples = rng.uniform(lo, hi, size=(500, len(bounds)))
    X_train = host(gp.X[gp.mask > 0]).numpy()
    samples = np.vstack([samples, X_train])

    def t(a):
        return torch.as_tensor(a, dtype=gp.X.dtype, device=gp.X.device)

    with torch.no_grad():
        vals = host(_neg_grad_norm(gp, post, t(samples))).numpy()
    x0 = samples[int(np.argmin(vals))]
    res = lbfgs.minimize(lambda X: _neg_grad_norm(gp, post, X), t(x0), lower=t(lo),
                         upper=t(hi), maxiter=200, carry_graph=False)
    L = float(host(-res.f))
    if L < 1e-7:
        L = 10.0  # to avoid problems in cases in which the model is flat
    return L


class LocalPenalization(EvaluatorBase):
    """Greedy local-penalization batch (batch_local_penalization.py:9): the
    first point is the acquisition's argmax, each next one the argmax of the
    acquisition penalized around the points chosen so far. ``seconds`` holds
    the last batch's host-clock split: ``estimate_L`` and one entry per argmax
    (each ends in a host read, so the device work is inside)."""

    def __init__(self, acquisition, batch_size):
        if not isinstance(acquisition, AcquisitionLP):
            raise TypeError("LocalPenalization needs an AcquisitionLP")
        super().__init__(acquisition, batch_size)
        self.seconds = {}

    def compute_batch(self, duplicate_manager=None, context_manager=None):
        acq = self.acquisition
        seconds = {"estimate_L": 0.0, "argmax": []}
        acq.update_batches(None, None, None)
        t0 = time.perf_counter()
        with span("lp.argmax"):
            X_batch, _ = acq.optimize(duplicate_manager=duplicate_manager)
        seconds["argmax"].append(time.perf_counter() - t0)
        if self.batch_size > 1:
            t0 = time.perf_counter()
            with span("lp.estimate_L"):
                L = estimate_L(acq.model, acq.space.get_bounds())
            seconds["estimate_L"] = time.perf_counter() - t0
            Min = acq.model.Y_min()
        while X_batch.shape[0] < self.batch_size:
            acq.update_batches(X_batch, L, Min)
            t0 = time.perf_counter()
            with span("lp.argmax"):
                new_sample, _ = acq.optimize(duplicate_manager=duplicate_manager)
            seconds["argmax"].append(time.perf_counter() - t0)
            X_batch = np.vstack((X_batch, new_sample))
        acq.update_batches(None, None, None)
        self.seconds = seconds
        return X_batch

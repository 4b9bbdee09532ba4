"""Objective evaluation (twin of ``gaussian_process_optimization_tpu/bo/objective.py``;
GPyOpt core/task/objective.py:20 ``SingleObjective``): row-wise evaluation on the
host with per-evaluation wall time (:64-76) and an optional fan-out over
processes (``num_cores > 1``, :80-100) that falls back to the serial loop on any
error (:52-58). The objective is the external system being optimized: it runs on
the host.
"""
from __future__ import annotations

import time

import numpy as np


class Objective:
    def evaluate(self, x):
        raise NotImplementedError


class SingleObjective(Objective):
    def __init__(self, func, num_cores=1, objective_name="no_name", space=None,
                 unfold_args=False):
        self.func = func
        self.num_cores = int(num_cores)
        self.objective_name = objective_name
        self.space = space
        self.unfold_args = unfold_args

    def evaluate(self, x):
        """(n, d) -> (f_evals (n,1), cost_evals (n,1) wall seconds)."""
        x = np.atleast_2d(x)
        if self.num_cores == 1:
            return self._eval_func(x)
        try:
            return self._syncronous_batch_evaluation(x)
        except Exception:  # parallel error -> serial fallback (objective.py:52-58)
            if hasattr(self, "parallel_error") is False:
                print("Error in parallel computation. Fall back to single process!")
            self.parallel_error = True
            return self._eval_func(x)

    def _eval_func(self, x):
        """Serial row-wise evaluation with cost timing (objective.py:64-76)."""
        f_evals = np.empty((0, 1))
        cost_evals = []
        for i in range(x.shape[0]):
            st = time.time()
            rlt = self.func(np.atleast_2d(x[i]))
            f_evals = np.vstack([f_evals, np.atleast_2d(np.asarray(rlt, dtype=float).reshape(1, -1)[:, :1])])
            cost_evals.append(time.time() - st)
        return f_evals, np.atleast_2d(np.asarray(cost_evals)).T

    def _syncronous_batch_evaluation(self, x):
        """Process/Pipe fan-out over num_cores (objective.py:80-100)."""
        from multiprocessing import Pipe, Process

        divided_samples = [x[i :: self.num_cores] for i in range(self.num_cores)]
        pipe = [Pipe() for _ in range(self.num_cores)]
        proc = [
            Process(target=spawn_process, args=(self.func, k, p))
            for k, (p, _) in zip(divided_samples, pipe)
        ]
        [p.start() for p in proc]
        [p.join() for p in proc]

        f_evals = np.zeros((x.shape[0], 1))
        for i, (_, c) in enumerate(pipe):
            f_part, _cost_part = c.recv()
            f_evals[i :: self.num_cores] = f_part
        # cost pinned to 1 for synchronous batches, matching objective.py:96
        # ("the time of evaluation is set to constant"): per-row wall times in a
        # parallel batch measure worker contention, not objective cost, and
        # would skew the 'evaluation_time' cost model vs the reference
        return f_evals, np.ones((x.shape[0], 1))


def spawn_process(func, samples, pipe_end):
    f_evals = np.empty((0, 1))
    costs = []
    for row in np.atleast_2d(samples):
        st = time.time()
        val = func(np.atleast_2d(row))
        f_evals = np.vstack([f_evals, np.atleast_2d(np.asarray(val, dtype=float).reshape(1, -1)[:, :1])])
        costs.append(time.time() - st)
    pipe_end.send((f_evals, np.atleast_2d(np.asarray(costs)).T))

"""Objective evaluation (twin of ``gaussian_process_optimization_tpu/bo/objective.py``;
GPyOpt core/task/objective.py:20 ``SingleObjective``): row-wise evaluation on the
host with per-evaluation wall time (:64-76). The multiprocessing fan-out
(``num_cores > 1``, :80-100) is not ported."""
from __future__ import annotations

import time

import numpy as np


class SingleObjective:
    def __init__(self, func, num_cores=1):
        if int(num_cores) != 1:
            raise NotImplementedError("parallel evaluation (num_cores > 1) is not ported")
        self.func = func

    def evaluate(self, x):
        """(n, d) -> (f_evals (n, 1), cost_evals (n, 1) wall seconds)."""
        x = np.atleast_2d(x)
        f_evals, cost_evals = [], []
        for row in x:
            st = time.time()
            rlt = self.func(np.atleast_2d(row))
            f_evals.append(np.asarray(rlt, dtype=float).reshape(1, -1)[:, :1])
            cost_evals.append(time.time() - st)
        return np.vstack(f_evals), np.atleast_2d(np.asarray(cost_evals)).T

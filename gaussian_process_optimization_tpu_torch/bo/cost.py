"""Evaluation-cost model (twin of ``gaussian_process_optimization_tpu/bo/cost.py``;
GPyOpt core/task/cost.py:8 ``CostModel``): None is the constant cost 1;
'evaluation_time' is a GP fitted to the log of the evaluation time, the
acquisition divided by exp(mu_cost) (:32-56); anything else is the user's own
``cost_withGradients(x) -> (cost (n, 1), dcost/dx (n, d))``."""
from __future__ import annotations

import numpy as np
import torch

from ..models.bo_models import GPModel
from .acquisitions import constant_cost_withGradients


class CostModel:
    """``device`` and ``dtype`` place the log-cost surrogate; ``device`` None
    means the card, as for the objective's surrogate."""

    def __init__(self, cost_withGradients, device=None, dtype=torch.float64):
        self.cost_type = cost_withGradients
        if cost_withGradients is None:
            self.cost_withGradients = constant_cost_withGradients
            self.cost_type = "constant"
        elif cost_withGradients == "evaluation_time":
            self.cost_model = GPModel(exact_feval=False, optimize_restarts=2, max_iters=200,
                                      device=device, dtype=dtype)
            self.cost_withGradients = self._cost_gp_withGradients
            self.num_updates = 0
        else:
            self.cost_withGradients = cost_withGradients
            self.cost_type = "user_defined"

    def _cost_gp(self, x):
        """exp of the log-cost GP's mean (cost.py:32-40)."""
        m, _ = self.cost_model.predict(x)
        return np.exp(m)

    def _cost_gp_withGradients(self, x):
        """(cost.py:48-53); the unit cost until there is cost data."""
        if self.num_updates == 0:
            return constant_cost_withGradients(x)
        m, _, dmdx, _ = self.cost_model.predict_withGradients(x)
        return np.exp(m), np.exp(m) * dmdx

    def update_cost_model(self, x, cost_x):
        """Refit the log-cost GP (cost.py:55-74)."""
        if self.cost_type != "evaluation_time":
            return
        cost_evals = np.log(np.atleast_2d(np.asarray(cost_x, dtype=float)).reshape(-1, 1))
        if self.num_updates == 0:
            self.cost_X = np.atleast_2d(x)
            self.cost_Y = cost_evals
        else:
            self.cost_X = np.vstack([self.cost_X, np.atleast_2d(x)])
            self.cost_Y = np.vstack([self.cost_Y, cost_evals])
        self.num_updates += 1
        self.cost_model.updateModel(self.cost_X, self.cost_Y)

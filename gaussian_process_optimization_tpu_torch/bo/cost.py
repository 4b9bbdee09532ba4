"""Evaluation-cost model (twin of ``gaussian_process_optimization_tpu/bo/cost.py``;
GPyOpt core/task/cost.py:8 ``CostModel``). Only the constant cost
(``cost_withGradients=None``) is ported; the 'evaluation_time' GP cost model and
user cost functions are not yet."""
from __future__ import annotations


class CostModel:
    def __init__(self, cost_withGradients):
        if cost_withGradients is not None:
            raise NotImplementedError("only the constant cost (None) is ported")

    def update_cost_model(self, x, cost_x):
        """The constant cost learns nothing (cost.py:55-74)."""

"""Design space (twin of ``gaussian_process_optimization_tpu/bo/space.py``;
GPyOpt/GPyOpt/core/task/space.py:13 ``Design_space``), host numpy.

The mixed continuous/discrete/categorical/bandit domain with the model-space vs
objective-space duality (one-hot categorical expansion, :133), zip/unzip
(:220-236), bounds (:263), per-variable rounding (:328), indicator constraints
(:303), and the reference author's ``lengthscales`` (:352), the continuous value
ranges the Gower kernel divides by.

Constraints are callables c(x_2d) -> (n,) with c(x) <= 0 feasible, or numpy
string expressions in x (the reference exec's them, space.py:303).
"""
from __future__ import annotations

import numpy as np

from .variables import InvalidConfigError, Variable, create_variable


class DesignSpace:
    def __init__(self, space, constraints=None):
        """space: GPyOpt-style dicts (name/type/domain/dimensionality) or
        Variable objects. constraints: dicts {'name', 'constraint'} whose
        constraint is a callable or a numpy string expression in x."""
        self.config_space = space
        self.space = [v if isinstance(v, Variable) else create_variable(v) for v in space]
        self.space_expanded: list[Variable] = []
        for v in self.space:
            self.space_expanded.extend(v.expand())
        names = [v.name for v in self.space_expanded]
        if len(set(names)) != len(names):
            raise InvalidConfigError(f"duplicate variable names in {names}")
        self.constraints = list(constraints) if constraints else []

        # bandit variables occupy several objective columns, the others one each
        self.objective_dimensionality = sum(
            v.dimensionality if v.is_bandit else 1 for v in self.space_expanded)
        self.model_dimensionality = sum(v.dimensionality_in_model
                                        for v in self.space_expanded)
        self._model_slices = []
        self._objective_slices = []
        midx = oidx = 0
        for v in self.space_expanded:
            self._model_slices.append(slice(midx, midx + v.dimensionality_in_model))
            midx += v.dimensionality_in_model
            owidth = v.dimensionality if v.is_bandit else 1
            self._objective_slices.append(slice(oidx, oidx + owidth))
            oidx += owidth

    def has_constraints(self):
        return len(self.constraints) > 0

    def get_continuous_dims(self):
        """Objective-space column indices of the continuous variables."""
        return [self._objective_slices[i].start
                for i, v in enumerate(self.space_expanded) if v.is_continuous]

    def get_discrete_dims(self):
        return [self._objective_slices[i].start
                for i, v in enumerate(self.space_expanded) if v.is_discrete]

    def get_discrete_values(self):
        """Allowed values per discrete variable (space.py:460)."""
        return [list(v.domain) for v in self.space_expanded if v.is_discrete]

    def get_bounds(self):
        """Model-space bounds (space.py:263)."""
        bounds = []
        for v in self.space_expanded:
            bounds.extend(v.get_bounds())
        return bounds

    def get_continuous_bounds(self):
        return [v.get_bounds()[0] for v in self.space_expanded if v.is_continuous]

    def lengthscales(self):
        """Continuous value ranges, the Gower kernel's normalizers (space.py:352)."""
        return [v.domain[-1] - v.domain[0] for v in self.space_expanded if v.is_continuous]

    def objective_to_model(self, x_obj):
        """One row, objective -> model coordinates (one-hot expand categoricals)."""
        out = []
        x_obj = np.asarray(x_obj)
        for v, osl in zip(self.space_expanded, self._objective_slices):
            val = x_obj[osl] if v.is_bandit else x_obj[osl][0]
            out.extend(v.objective_to_model(val))
        return out

    def model_to_objective(self, x_model):
        out = []
        for v, sl in zip(self.space_expanded, self._model_slices):
            val = v.model_to_objective(list(np.asarray(x_model)[sl]))
            if v.is_bandit:
                out.extend(val)
            else:
                out.append(val)
        return out

    def unzip_inputs(self, X):
        """(n, objective_dim) -> (n, model_dim) (space.py:220)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        return np.asarray([self.objective_to_model(row) for row in X], dtype=float)

    def zip_inputs(self, X):
        """(n, model_dim) -> (n, objective_dim) (space.py:228)."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        return np.asarray([self.model_to_objective(row) for row in X], dtype=float)

    def round_optimum(self, x):
        """Round a model-space point variable by variable (space.py:328)."""
        x = np.asarray(x, dtype=float).ravel()
        out = []
        for v, sl in zip(self.space_expanded, self._model_slices):
            out.extend(v.round(x[sl]))
        return np.atleast_2d(np.asarray(out, dtype=float))

    def indicator_constraints(self, x):
        """{0, 1} feasibility per row, c(x) <= 0 feasible (space.py:303)."""
        x = np.atleast_2d(np.asarray(x, dtype=float))
        ind = np.ones((x.shape[0], 1))
        for c in self.constraints:
            expr = c["constraint"] if isinstance(c, dict) else c
            if callable(expr):
                vals = expr(x)
            else:
                vals = eval(expr, {"np": np, "numpy": np, "x": x})  # noqa: S307
            fail = np.any(np.asarray(vals, dtype=float).reshape(x.shape[0], -1) > 0, axis=1)
            ind[fail, :] = 0.0
        return ind


def bounds_to_space(bounds):
    """Legacy [(lo, hi), ...] -> space dicts (space.py:519)."""
    return [{"name": f"var_{i + 1}", "type": "continuous", "domain": b, "dimensionality": 1}
            for i, b in enumerate(bounds)]

"""Design space (twin of ``gaussian_process_optimization_tpu/bo/space.py``;
GPyOpt/GPyOpt/core/task/space.py:13 ``Design_space``), host numpy.

The mixed continuous/discrete/categorical/bandit domain with the model-space vs
objective-space duality (one-hot categorical expansion, :133), zip/unzip
(:220-236), bounds (:263), per-variable rounding (:328), indicator constraints
(:303), uniform sampling, and the reference author's additions: ``has_discrete``
(:280), ``lengthscales`` (:352, the continuous value ranges the Gower kernel
divides by), the zero-start shifts (:364) and the discrete grid (:473).

Constraints are callables c(x_2d) -> (n,) with c(x) <= 0 feasible, or numpy
string expressions in x (the reference exec's them, space.py:303).
"""
from __future__ import annotations

import itertools

import numpy as np

from ..utils.profiling import spanned
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

    def has_types(self):
        return {t: any(v.type == t for v in self.space_expanded)
                for t in ("continuous", "discrete", "categorical", "bandit")}

    def has_continuous(self):
        return any(v.is_continuous for v in self.space_expanded)

    def has_discrete(self):
        return any(v.is_discrete for v in self.space_expanded)

    def has_constraints(self):
        return len(self.constraints) > 0

    def get_continuous_dims(self):
        """Objective-space column indices of the continuous variables."""
        return [self._objective_slices[i].start
                for i, v in enumerate(self.space_expanded) if v.is_continuous]

    def get_discrete_dims(self):
        return [self._objective_slices[i].start
                for i, v in enumerate(self.space_expanded) if v.is_discrete]

    def get_categorical_dims(self):
        return [self._objective_slices[i].start
                for i, v in enumerate(self.space_expanded) if v.is_categorical]

    def get_continuous_space(self):
        return [v for v in self.space_expanded if v.is_continuous]

    def get_discrete_space(self):
        return [v for v in self.space_expanded if v.is_discrete]

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

    def zeroStart_shifted_bounds(self):
        return [(0, v.domain[-1] - v.domain[0]) for v in self.space_expanded]

    def _shifts(self):
        return np.asarray([v.domain[0] for v in self.space_expanded], dtype=float)

    def fit_to_zeroStart_shifted_bounds(self, X):
        return np.asarray(X, dtype=float) - self._shifts()

    def revert_from_zeroStart_shifted_bounds(self, X):
        return np.asarray(X, dtype=float) + self._shifts()

    def get_discrete_grid(self):
        """Cartesian product of the discrete variables' values (space.py:473)."""
        return np.asarray(list(itertools.product(*self.get_discrete_values())), dtype=float)

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

    @spanned("space.unzip")
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

    def sample_uniform(self, n, rng):
        """``n`` uniform draws, variable by variable from the numpy Generator
        ``rng``, in objective space."""
        cols = []
        for v in self.space_expanded:
            if v.is_continuous:
                cols.append(rng.uniform(v.domain[0], v.domain[-1], size=n))
            elif v.is_bandit:
                idx = rng.integers(0, v.domain.shape[0], size=n)
                cols.extend(v.domain[idx, d] for d in range(v.domain.shape[1]))
            else:
                vals = np.asarray(v.domain, dtype=float)
                cols.append(vals[rng.integers(0, len(vals), size=n)])
        return np.stack(cols, axis=1)

    def input_dim(self):
        return self.objective_dimensionality


def bounds_to_space(bounds):
    """Legacy [(lo, hi), ...] -> space dicts (space.py:519)."""
    return [{"name": f"var_{i + 1}", "type": "continuous", "domain": b, "dimensionality": 1}
            for i, b in enumerate(bounds)]

"""Design-space variables (twin of ``gaussian_process_optimization_tpu/bo/variables.py``;
GPyOpt/GPyOpt/core/task/variables.py: Variable:6,
ContinuousVariable:89, BanditVariable:121, DiscreteVariable:166, CategoricalVariable:198,
factory create_variable:237).

Host-side (numpy) objects: they define the static structure — dimensionalities, bounds,
encodings — of the design space. Two coordinate systems, as in the
reference: *objective space* (one column per variable) and *model space* (categoricals
one-hot expanded, space.py:133).
"""
from __future__ import annotations

import numpy as np


class InvalidConfigError(Exception):
    pass


class FullyExploredOptimizationDomainError(Exception):
    pass


class Variable:
    type: str = "base"
    is_continuous = False
    is_discrete = False  # author's addition (variables.py:16)
    is_categorical = False
    is_bandit = False

    def __init__(self, name, domain, dimensionality=1):
        self.name = name
        self.domain = domain
        self.dimensionality = dimensionality
        self.dimensionality_in_model = 1

    def expand(self):
        """dimensionality>1 -> var_1, var_2, ... (space.py:193 _expand_space)."""
        if self.dimensionality == 1:
            return [self]
        out = []
        for i in range(self.dimensionality):
            v = type(self)(f"{self.name}_{i + 1}", self.domain, 1)
            out.append(v)
        return out

    # model-space encode/decode
    def objective_to_model(self, value):
        return [value]

    def model_to_objective(self, values):
        return values[0]

    def get_bounds(self):
        raise NotImplementedError

    def round(self, value_array):
        raise NotImplementedError


class ContinuousVariable(Variable):
    type = "continuous"
    is_continuous = True

    def get_bounds(self):
        return [tuple(self.domain)]

    def round(self, value_array):
        """Clamp into the interval (variables.py:103-118)."""
        lo, hi = self.domain[0], self.domain[-1]
        return [min(max(float(value_array[0]), lo), hi)]


class DiscreteVariable(Variable):
    type = "discrete"
    is_discrete = True

    def get_bounds(self):
        return [(min(self.domain), max(self.domain))]

    def round(self, value_array):
        """Snap to the nearest allowed value (variables.py:181-196)."""
        vals = np.asarray(self.domain, dtype=float)
        return [float(vals[np.argmin(np.abs(vals - float(value_array[0])))])]


class CategoricalVariable(Variable):
    type = "categorical"
    is_categorical = True

    def __init__(self, name, domain, dimensionality=1):
        super().__init__(name, domain, dimensionality)
        self.dimensionality_in_model = len(domain)

    def objective_to_model(self, value):
        """One-hot encode (space.py / variables.py:211-224)."""
        onehot = [0.0] * len(self.domain)
        idx = list(self.domain).index(value)
        onehot[idx] = 1.0
        return onehot

    def model_to_objective(self, values):
        return self.domain[int(np.argmax(values))]

    def get_bounds(self):
        return [(0.0, 1.0)] * len(self.domain)

    def round(self, value_array):
        """argmax one-hot (variables.py:225-233)."""
        onehot = [0.0] * len(self.domain)
        onehot[int(np.argmax(np.asarray(value_array)))] = 1.0
        return onehot


class BanditVariable(Variable):
    """A finite set of allowed D-dim points (rows of `domain`), variables.py:121."""

    type = "bandit"
    is_bandit = True

    def __init__(self, name, domain, dimensionality=None):
        domain = np.atleast_2d(np.asarray(domain, dtype=float))
        dims = domain.shape[1]
        super().__init__(name, domain, dims)
        self.dimensionality = dims
        self.dimensionality_in_model = dims

    def expand(self):
        return [self]

    def objective_to_model(self, value):
        return list(np.asarray(value, dtype=float).ravel())

    def model_to_objective(self, values):
        return list(values)

    def get_bounds(self):
        return [(float(c.min()), float(c.max())) for c in self.domain.T]

    def round(self, value_array):
        x = np.asarray(value_array, dtype=float)
        d2 = ((self.domain - x[None, :]) ** 2).sum(1)
        return list(self.domain[int(np.argmin(d2))])


def create_variable(descriptor) -> Variable:
    """Factory from a GPyOpt-style domain dict (variables.py:237)."""
    d = dict(descriptor)
    vtype = d.get("type", "continuous")
    name = d.get("name", "var")
    domain = d.get("domain")
    dim = int(d.get("dimensionality", 1))
    if domain is None:
        raise InvalidConfigError(f"variable {name} has no domain")
    table = {
        "continuous": ContinuousVariable,
        "discrete": DiscreteVariable,
        "categorical": CategoricalVariable,
        "bandit": BanditVariable,
    }
    if vtype not in table:
        raise InvalidConfigError(f"unknown variable type {vtype!r}")
    return table[vtype](name, tuple(domain) if vtype != "bandit" else domain, dim)

"""User-expression kernel (twin of ``gaussian_process_optimization_tpu/kernels/symbolic.py``;
GPy symbolic.py:8).

The reference takes a JAX-traceable callable ``expr(x, z, params)`` over
single points and differentiates it with ``jax.grad``. Here ``expr`` is a
torch callable over single points, mapped over the pairs with
``torch.func.vmap``, and autograd is its derivative. ``from_sympy`` lambdifies a
sympy expression to torch when sympy is installed and raises ImportError
otherwise, as the reference does.

Lanes: a leaf of ``params`` may carry a leading lane axis; ``expr`` then sees
one lane's values at a time and ``K`` returns ``lanes + (N, M)``. The lanes
are read off the first leaf: ``lane_ndim`` (static) says how many leading axes
of each leaf are lanes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from .base import Kernel, as_leaf, dims_of, placement


@dataclasses.dataclass(frozen=True)
class SymbolicKernel(Kernel):
    """K[i, j] = expr(X[i], X2[j], params); ``params`` a dict of tensors (each
    name's constraint as ``models/parameters.py`` gives it)."""

    params: dict = None
    expr: Callable = None
    shapes: tuple = ()

    @classmethod
    def create(cls, input_dim, expr, params=None, active_dims=None, dtype=None, device=None):
        where = placement(dtype, device)
        params = {k: as_leaf(v, **where) for k, v in (params or {}).items()}
        return cls(input_dim=input_dim, active_dims=dims_of(active_dims), params=params,
                   expr=expr, shapes=tuple((k, tuple(v.shape)) for k, v in params.items()))

    @classmethod
    def from_sympy(cls, input_dim, sym_expr, x_syms, z_syms, param_syms, params=None,
                   active_dims=None, dtype=None, device=None):
        """Lambdify a sympy expression to torch (needs sympy, as the reference's
        ``import sympy`` does)."""
        try:
            import sympy
        except ImportError as e:
            raise ImportError("SymbolicKernel.from_sympy requires sympy (not installed); "
                              "pass a torch callable to SymbolicKernel.create instead") from e
        names = [str(s) for s in param_syms]
        modules = [{"exp": torch.exp, "sqrt": torch.sqrt, "sin": torch.sin, "cos": torch.cos,
                    "log": torch.log, "tanh": torch.tanh, "pi": math.pi}, "math"]
        f = sympy.lambdify(list(x_syms) + list(z_syms) + list(param_syms), sym_expr,
                           modules=modules)

        def expr(x, z, p):
            return f(*x, *z, *[p[n] for n in names])

        return cls.create(input_dim, expr, params=params, active_dims=active_dims, dtype=dtype,
                          device=device)

    def _lanes(self):
        """The leading lane axes of the leaves, ``()`` without lanes."""
        for name, shape in self.shapes:
            v = self.params[name]
            return tuple(v.shape[: v.ndim - len(shape)])
        return ()

    def _map(self, fn):
        """``fn(params)`` for every lane, stacked in front."""
        lanes = self._lanes()
        if not lanes:
            return fn(self.params)
        flat = {k: v.reshape((-1,) + v.shape[len(lanes):]) for k, v in self.params.items()}
        out = torch.func.vmap(fn)(flat)
        return out.reshape(lanes + out.shape[1:])

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)

        def one(p):
            row = torch.func.vmap(lambda x, z: self.expr(x, z, p), in_dims=(None, 0))
            return torch.func.vmap(lambda x: row(x, X2))(X)

        return self._map(one)

    def Kdiag(self, X):
        X = self._slice(X)
        return self._map(lambda p: torch.func.vmap(lambda x: self.expr(x, x, p))(X))

"""Mean functions / mappings (twin of
``gaussian_process_optimization_tpu/models/mean_functions.py``; GPy/GPy/mappings/:
Constant, Linear, Additive, Compound, Kernel, MLP, Identity, PiecewiseLinear).

The GP's optional prior mean m(x). A mapping is a frozen dataclass whose tensor
fields are its parameters; their gradients flow by autograd through the LML
(``GPRegression._normalized_Y``). A parameter may carry a leading lane axis (one
set of values per optimizer restart): ``f`` of ``X (N, D)`` then returns
``(B, N, P)``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.base import Kernel


def _param(v, dtype, device):
    return torch.as_tensor(np.asarray(v, dtype=float), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class Mapping:
    input_dim: int = 1
    output_dim: int = 1

    def f(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(Mapping):
    """m(x) = C (GPy mappings/constant.py)."""

    C: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, output_dim=1, value=0.0, dtype=None, device=None):
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        return cls(input_dim=input_dim, output_dim=output_dim,
                   C=torch.full((output_dim,), float(value), dtype=dtype, device=device))

    def f(self, X):
        C = self.C[..., None, :]
        batch = torch.broadcast_shapes(C.shape[:-2], X.shape[:-2])
        return C.expand(batch + (X.shape[-2], self.output_dim))


@dataclasses.dataclass(frozen=True)
class LinearMapping(Mapping):
    """m(x) = X A (GPy mappings/linear.py)."""

    A: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, output_dim=1, A=None, dtype=None, device=None):
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        A = (_param(A, dtype, device) if A is not None
             else torch.zeros((input_dim, output_dim), dtype=dtype, device=device))
        return cls(input_dim=input_dim, output_dim=output_dim, A=A)

    def f(self, X):
        return X @ self.A


@dataclasses.dataclass(frozen=True)
class Additive(Mapping):
    """m(x) = m1(x) + m2(x) (GPy mappings/additive.py)."""

    m1: Mapping = None
    m2: Mapping = None

    def f(self, X):
        return self.m1.f(X) + self.m2.f(X)


@dataclasses.dataclass(frozen=True)
class Compound(Mapping):
    """m(x) = m2(m1(x)) (GPy mappings/compound.py)."""

    m1: Mapping = None
    m2: Mapping = None

    def f(self, X):
        return self.m2.f(self.m1.f(X))


@dataclasses.dataclass(frozen=True)
class Identity(Mapping):
    """m(x) = x (GPy mappings/identity.py)."""

    @classmethod
    def create(cls, input_dim, output_dim=None):
        return cls(input_dim=input_dim, output_dim=output_dim or input_dim)

    def f(self, X):
        return X


@dataclasses.dataclass(frozen=True)
class KernelMapping(Mapping):
    """m(x) = K(x, Z) A, a kernel basis mapping (GPy mappings/kernel.py:9-48);
    ``A (num_bases, output_dim)`` is trainable."""

    kern: Kernel = None
    Z: torch.Tensor = None
    A: torch.Tensor = None

    @classmethod
    def create(cls, input_dim, output_dim, Z, kernel=None, A=None, seed=0,
               dtype=None, device=None):
        from ..kernels.stationary import RBF

        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        Z = _param(Z, dtype, device)
        if kernel is None:
            kernel = RBF.create(input_dim, dtype=dtype, device=device)
        if A is None:
            A = np.random.default_rng(seed).standard_normal((Z.shape[0], output_dim))
        return cls(input_dim=input_dim, output_dim=output_dim, kern=kernel, Z=Z,
                   A=_param(A, dtype, device))

    def f(self, X):
        return self.kern.K(X, self.Z) @ self.A


@dataclasses.dataclass(frozen=True)
class MLPMapping(Mapping):
    """Single-hidden-layer tanh MLP mean (GPy mappings/mlp.py:9-40):
    m(x) = tanh(x W1 + b1) W2 + b2."""

    W1: torch.Tensor = None
    b1: torch.Tensor = None
    W2: torch.Tensor = None
    b2: torch.Tensor = None

    @classmethod
    def create(cls, input_dim=1, output_dim=1, hidden_dim=3, seed=0, dtype=None,
               device=None):
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        rng = np.random.default_rng(seed)
        return cls(input_dim=input_dim, output_dim=output_dim,
                   W1=_param(rng.standard_normal((input_dim, hidden_dim)), dtype, device),
                   b1=_param(rng.standard_normal(hidden_dim), dtype, device),
                   W2=_param(rng.standard_normal((hidden_dim, output_dim)), dtype, device),
                   b2=_param(rng.standard_normal(output_dim), dtype, device))

    def f(self, X):
        hidden = torch.tanh(X @ self.W1 + self.b1[..., None, :])
        return hidden @ self.W2 + self.b2[..., None, :]


@dataclasses.dataclass(frozen=True)
class PiecewiseLinear(Mapping):
    """1-D piecewise-linear mean with unit slope outside the breaks (GPy
    mappings/piecewise_linear.py:5-52); ``values`` and ``breaks`` are
    trainable. No lane axis."""

    values: torch.Tensor = None
    breaks: torch.Tensor = None

    @classmethod
    def create(cls, values, breaks, dtype=None, device=None):
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        return cls(input_dim=1, output_dim=1,
                   values=_param(values, dtype, device).reshape(-1),
                   breaks=_param(breaks, dtype, device).reshape(-1))

    def f(self, X):
        x = X.reshape(-1)
        order = torch.argsort(self.breaks)
        b, v = self.breaks[order], self.values[order]
        # interior: interpolation on the segment that holds x
        hi = torch.clamp(torch.searchsorted(b.detach(), x.detach(), right=True),
                         1, b.shape[0] - 1)
        lo = hi - 1
        w = (x - b[lo]) / (b[hi] - b[lo])
        y_in = v[lo] + w * (v[hi] - v[lo])
        y = torch.where(x < b[0], x + v[0] - b[0],
                        torch.where(x > b[-1], x + v[-1] - b[-1], y_in))
        return y.reshape(-1, 1)

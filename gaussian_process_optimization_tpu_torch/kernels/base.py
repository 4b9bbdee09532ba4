"""Kernel base classes (twin of ``gaussian_process_optimization_tpu/kernels/base.py``):
``K``, ``Kdiag``, ``active_dims`` slicing, the ``Add`` / ``Prod`` algebra
(GPy add.py:10, prod.py:24), and the input derivatives ``gradients_X`` and
``d2K_dXdX2_diag``.

Kernels are frozen dataclasses whose tensor fields are the hyperparameters.
A hyperparameter may carry a leading lane axis (one set of values per
optimizer restart); ``K`` then returns ``(B, N, M)``. The parts of a
combination may or may not carry lanes: their sum or product broadcasts. Each
part builds its own K through its own ``K`` (a stationary part that passes the
kernel gate launches the CUDA K build); the sum or product of the parts is
plain tensor code, as it is plain array code in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device, resolve_dtype


@dataclasses.dataclass(frozen=True)
class Kernel:
    input_dim: int = 1
    active_dims: tuple | None = None

    def _slice(self, X):
        """``active_dims`` input slicing (GPy kernel_slice_operations)."""
        if X is None or self.active_dims is None:
            return X
        return X[..., list(self.active_dims)]

    def K(self, X: torch.Tensor, X2: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def Kdiag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _pairwise_diag(self, X):
        """O(N) diagonal from single-pair K evaluations, ``lanes + (N,)`` (the
        reference's ``_pairwise_diag``): for kernels whose closed forms live
        in K, the diagonal without the O(N^2) full K."""
        return torch.func.vmap(lambda a: self.K(a[None], a[None])[..., 0, 0])(X).movedim(0, -1)

    # combination algebra
    def __add__(self, other):
        parts = self._flat_parts(Add) + other._flat_parts(Add)
        return Add(parts=parts, input_dim=max(p.input_dim for p in parts))

    def __mul__(self, other):
        parts = self._flat_parts(Prod) + other._flat_parts(Prod)
        return Prod(parts=parts, input_dim=max(p.input_dim for p in parts))

    def _flat_parts(self, combo_cls):
        if isinstance(self, combo_cls):
            return tuple(self.parts)
        return (self,)

    def _leaf_like(self) -> torch.Tensor:
        """Some hyperparameter of this kernel (for dtype and device)."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v
            if isinstance(v, Kernel):
                return v._leaf_like()
            if isinstance(v, tuple) and v and isinstance(v[0], Kernel):
                return v[0]._leaf_like()
            if isinstance(v, dict) and v:
                return next(iter(v.values()))
        raise ValueError("kernel has no tensor field")

    def input_sensitivity(self, summarize=True):
        """Per-input-dimension relevance (GPy Kern.input_sensitivity: zeros
        unless a subclass defines one)."""
        like = self._leaf_like()
        return torch.zeros(self.input_dim, dtype=like.dtype, device=like.device)

    def _scatter_sensitivity(self):
        """This kernel's sensitivity placed at its ``active_dims`` positions
        (GPy CombinationKernel.input_sensitivity)."""
        s = self.input_sensitivity()
        if self.active_dims is None:
            return s.expand(self.input_dim)
        out = torch.zeros(max(self.active_dims) + 1, dtype=s.dtype, device=s.device)
        out[list(self.active_dims)] = s
        return out

    def gradients_X(self, dL_dK, X, X2=None):
        """d sum(K * dL_dK) / dX (GPy Kern.gradients_X, stationary.py:271)."""
        with torch.enable_grad():
            Xv = X.detach().requires_grad_(True)
            K = self.K(Xv) if X2 is None else self.K(Xv, X2)
            (g,) = torch.autograd.grad(torch.sum(K * dL_dK), Xv)
        return g

    def _k_pair(self, a, b):
        return self.K(a[None, :], b[None, :])[0, 0]

    def d2K_dXdX2_diag(self, x):
        """Prior mixed second derivative d2k(x1, x2)/dx1 dx2 at x1 == x2 == x,
        ``(D, D)``: the prior-curvature term of Cov[df/dx] in
        ``GPRegression.predict_jacobian``. Default: nested forward-mode
        differentiation of K, exact for kernels smooth at coincident inputs;
        the stationary kernels override it with the analytic r -> 0 limit
        (the guarded sqrt hides the sqrt families' curvature from it)."""
        inner = torch.func.jacfwd(self._k_pair, argnums=0)
        return torch.func.jacfwd(inner, argnums=1)(x, x)

    def _grad_X1_at_diag(self, x):
        """d k(x1, x2)/dx1 at x1 == x2 == x, ``(D,)``."""
        return torch.func.jacfwd(lambda a: self._k_pair(a, x))(x)

    def _grad_X2_at_diag(self, x):
        return torch.func.jacfwd(lambda b: self._k_pair(x, b))(x)


def grid(v: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar (shape ``lanes``) shaped to broadcast against
    ``lanes + (N, M)``."""
    return v[..., None, None]


def placement(dtype=None, device=None) -> dict:
    """``dtype`` and ``device`` of a kernel built by ``create``: the card and
    float32 unless named (``config.resolve_device`` / ``resolve_dtype``)."""
    device = resolve_device(device)
    return {"dtype": resolve_dtype(dtype, device), "device": device}


def as_leaf(v, like: torch.Tensor | None = None, dtype=None, device=None) -> torch.Tensor:
    """A hyperparameter given as a number, array or tensor, as a tensor of the
    dtype and device of ``like`` (or the ones given)."""
    if like is not None:
        dtype, device = like.dtype, like.device
    if isinstance(v, torch.Tensor):
        return v.detach().to(dtype=dtype, device=device)
    return torch.as_tensor(np.asarray(v, dtype=float), dtype=dtype, device=device)


def dims_of(active_dims):
    return tuple(int(d) for d in active_dims) if active_dims is not None else None


def _product(terms):
    out = None
    for t in terms:
        out = t if out is None else out * t
    return out


@dataclasses.dataclass(frozen=True)
class Add(Kernel):
    """Sum of kernels (GPy add.py:10)."""

    parts: tuple = ()

    def K(self, X, X2=None):
        return sum(p.K(X, X2) for p in self.parts)

    def Kdiag(self, X):
        return sum(p.Kdiag(X) for p in self.parts)

    def d2K_dXdX2_diag(self, x):
        return sum(p.d2K_dXdX2_diag(x) for p in self.parts)

    def input_sensitivity(self, summarize=True):
        return _combined_sensitivity(self)


@dataclasses.dataclass(frozen=True)
class Prod(Kernel):
    """Product of kernels (GPy prod.py:24). The symmetric build under autograd
    is rematerialized, as ``kernels/gower.py`` does and as the reference does
    with ``jax.checkpoint``: the product chain otherwise keeps two ``(B, N, N)``
    operands per part for the backward."""

    parts: tuple = ()

    def _build(self, X, X2):
        return _product(p.K(X, X2) for p in self.parts)

    def K(self, X, X2=None):
        if X2 is None and torch.is_grad_enabled():
            return checkpoint(self._build, X, None, use_reentrant=False)
        return self._build(X, X2)

    def Kdiag(self, X):
        return _product(p.Kdiag(X) for p in self.parts)

    def d2K_dXdX2_diag(self, x):
        """Product rule at the diagonal: for F = prod_i k_i,
        d2F/dx1 dx2 = sum_i H_i prod_{j != i} v_j
                    + sum_{i != j} g1_i g2_j^T prod_{l not in {i, j}} v_l,
        with v_i = k_i(x, x), g1 / g2 the first partials at the diagonal and
        H_i each part's own ``d2K_dXdX2_diag`` (GPy prod.py gradients_XX)."""
        parts = self.parts
        v = [p._k_pair(x, x) for p in parts]
        g1 = [p._grad_X1_at_diag(x) for p in parts]
        g2 = [p._grad_X2_at_diag(x) for p in parts]
        H = [p.d2K_dXdX2_diag(x) for p in parts]
        n = len(parts)
        out = 0.0
        for i in range(n):
            rest = _product([v[j] for j in range(n) if j != i] or [1.0])
            out = out + H[i] * rest
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                rest = _product([v[k] for k in range(n) if k not in (i, j)] or [1.0])
                out = out + torch.outer(g1[i], g2[j]) * rest
        return out

    def input_sensitivity(self, summarize=True):
        return _combined_sensitivity(self)


def _combined_sensitivity(combo):
    """Summed per-dimension sensitivity over a combination's parts, each
    scattered to its ``active_dims`` (GPy kern.py CombinationKernel:592)."""
    pieces = [p._scatter_sensitivity() for p in combo.parts]
    width = max([combo.input_dim] + [int(p.shape[0]) for p in pieces])
    out = torch.zeros(width, dtype=pieces[0].dtype, device=pieces[0].device)
    for s in pieces:
        out[: s.shape[0]] += s
    return out

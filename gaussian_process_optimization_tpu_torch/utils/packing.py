"""Model <-> flat unconstrained vector (twin of ``gaussian_process_optimization_tpu/utils/packing.py``).

The vector holds the free leaves, each through its transform's inverse, in the
reference's pytree leaf order. ``unpack`` and ``map_restart`` take any leading
lane axes: ``u`` of shape ``(B, n)`` gives a model whose free leaves carry a
leading ``B`` (the explicit stand-in for the reference's ``vmap`` over restarts).
"""
from __future__ import annotations

from typing import Any

import torch

from .transforms import IDENTITY, Transform
from .tree import named_leaves, replace_leaves


class Packer:
    """transforms / fixed: one entry per leaf of ``template`` (None = identity)."""

    def __init__(self, template: Any, transforms: list | None = None,
                 fixed: list | None = None):
        leaves = [t for _, t in named_leaves(template)]
        self._shapes = [tuple(t.shape) for t in leaves]
        self._sizes = [t.numel() for t in leaves]
        n = len(leaves)
        if transforms is None:
            transforms = [IDENTITY] * n
        if fixed is None:
            fixed = [False] * n
        if len(transforms) != n or len(fixed) != n:
            raise ValueError(
                f"spec has {len(transforms)} transforms / {len(fixed)} fixed "
                f"flags, template has {n} leaves")
        self._transforms: list[Transform] = [IDENTITY if t is None else t
                                             for t in transforms]
        self._fixed = [bool(f) for f in fixed]
        self.num_free = sum(s for s, f in zip(self._sizes, self._fixed) if not f)

    @property
    def transforms(self):
        return tuple(self._transforms)

    @property
    def fixed(self):
        return tuple(self._fixed)

    @property
    def shapes(self):
        """Each leaf's shape in the template (without lane axes)."""
        return tuple(self._shapes)

    def pack(self, model: Any) -> torch.Tensor:
        leaves = [t for _, t in named_leaves(model)]
        if len(leaves) != len(self._transforms):
            raise ValueError(
                f"model has {len(leaves)} leaves, packer template has "
                f"{len(self._transforms)} — structure mismatch")
        parts = [t.inverse(leaf).reshape(-1)
                 for leaf, t, fx in zip(leaves, self._transforms, self._fixed)
                 if not fx]
        return torch.cat(parts)

    def unpack(self, u: torch.Tensor, reference: Any) -> Any:
        """Constrained model from ``u`` (shape ``batch + (num_free,)``); fixed
        leaves (data, mask) come from ``reference`` unbatched."""
        batch = tuple(u.shape[:-1])
        ref_leaves = [t for _, t in named_leaves(reference)]
        out, idx = [], 0
        for ref, shape, size, t, fx in zip(ref_leaves, self._shapes, self._sizes,
                                           self._transforms, self._fixed):
            if fx:
                out.append(ref)
                continue
            seg = u[..., idx:idx + size].reshape(batch + shape)
            out.append(t.forward(seg.to(ref.dtype)))
            idx += size
        return replace_leaves(reference, out)

    def map_restart(self, z: torch.Tensor) -> torch.Tensor:
        """Standard-normal vectors (``batch + (num_free,)``) -> restart coordinates."""
        parts, idx = [], 0
        for size, t, fx in zip(self._sizes, self._transforms, self._fixed):
            if fx:
                continue
            parts.append(t.random_restart(z[..., idx:idx + size]))
            idx += size
        return torch.cat(parts, dim=-1)

    def map_constrained(self, fn, params: Any) -> list:
        """``[fn(leaf, is_fixed) for each leaf of params]``, in leaf order (for
        priors)."""
        leaves = [t for _, t in named_leaves(params)]
        return [fn(leaf, fx) for leaf, fx in zip(leaves, self._fixed)]

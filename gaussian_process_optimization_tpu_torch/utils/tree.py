"""Leaves of dataclass models, in the reference's pytree order.

The reference registers its models as JAX pytrees (``utils/pytree.py``): every
non-static dataclass field is a child, in declaration order. Here models are
plain frozen dataclasses of tensors, and these helpers walk the same order:
tensor fields are leaves, nested dataclasses are recursed into, a tuple or list
is walked item by item in order (``Add.parts``: path ``kern.parts.0.variance``),
a dict by its sorted keys, as JAX flattens one (``params.variance``), and
everything else (ints, None, bools, tuples of ints) is static.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _is_node(v) -> bool:
    return dataclasses.is_dataclass(v) and not isinstance(v, type)


def named_leaves(obj: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``[(dotted path, tensor), ...]`` in field order."""
    out = []

    def visit(v, path):
        if isinstance(v, torch.Tensor):
            out.append((path, v))
        elif _is_node(v):
            out.extend(named_leaves(v, path + "."))
        elif isinstance(v, (tuple, list)):
            for i, item in enumerate(v):
                visit(item, f"{path}.{i}")
        elif isinstance(v, dict):
            for k in sorted(v):
                visit(v[k], f"{path}.{k}")

    for f in dataclasses.fields(obj):
        visit(getattr(obj, f.name), prefix + f.name)
    return out


def replace_leaves(obj: Any, leaves: list[torch.Tensor]) -> Any:
    """Rebuild ``obj`` with its leaves replaced, in :func:`named_leaves` order."""
    it = iter(leaves)

    def rebuild_value(v):
        if isinstance(v, torch.Tensor):
            return next(it)
        if _is_node(v):
            return rebuild(v)
        if isinstance(v, (tuple, list)):
            return type(v)(rebuild_value(item) for item in v)
        if isinstance(v, dict):
            new = {k: rebuild_value(v[k]) for k in sorted(v)}
            return {k: new[k] for k in v}
        return v

    def rebuild(o):
        changes = {}
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            if isinstance(v, (torch.Tensor, tuple, list, dict)) or _is_node(v):
                changes[f.name] = rebuild_value(v)
        return dataclasses.replace(o, **changes)

    out = rebuild(obj)
    if next(it, None) is not None:
        raise ValueError("more leaves given than the model has")
    return out


def leaf_name(path: str) -> str:
    """The field a leaf belongs to: the last attribute name of its path (a
    tuple index is not a name, as in the reference's ``_leaf_names``)."""
    for part in reversed(path.split(".")):
        if not part.isdigit():
            return part
    return ""


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], obj: Any) -> Any:
    return replace_leaves(obj, [fn(t) for _, t in named_leaves(obj)])

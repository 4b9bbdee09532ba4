"""Carry a model from the JAX package into the port.

The JAX model's leaves, given as numpy arrays keyed by their leaf path,
become a ``GPRegression`` of this package. The kernel's leaves are

- a stationary kernel's: ``kern.variance``, ``kern.lengthscale``, optionally
  ``kern.power``;
- a Gower kernel's: ``kern.base.variance``, ``kern.base.lengthscale``,
  ``kern.ranges``;
- a combination's (``Add`` / ``Prod``): ``kern.parts.<i>.variance`` and so on,
  one stationary part per index;

then ``likelihood_variance`` (a scalar, or one value per row: the
heteroscedastic model), ``X``, ``Y``, optionally ``mask``, ``jitter_hint`` and a
mean function's leaves under ``mean_function.`` (``C``, ``A``, or the MLP's
``W1 b1 W2 b2``). What is static in the JAX model is passed beside the leaves:
the family, the Gower structure (continuous and discrete columns,
``gpy_compat``), a combination's operator with each part's family and
``active_dims``, and the mean function's class name. No JAX object is taken or
made.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import resolve_device
from .kernels.base import Add, Prod
from .kernels.gower import Gower
from .kernels.stationary import FAMILY_CLASSES
from .models import mean_functions
from .models.gp import GPRegression
from .utils.tree import named_leaves

_MEAN_FIELDS = {"Constant": ("C",), "LinearMapping": ("A",),
                "MLPMapping": ("W1", "b1", "W2", "b2")}


def gp_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "matern52",
                   gower: Mapping | None = None, composite: Mapping | None = None,
                   mean_function: str | None = None, dtype=torch.float64,
                   device=None) -> GPRegression:
    """``gower``: ``{"cont_dims": ..., "disc_dims": ..., "gpy_compat": ...}`` for a
    Gower kernel over a ``family`` base (the BO wrappers' kernel).
    ``composite``: ``{"op": "add" | "prod", "parts": [{"family": ...,
    "active_dims": ... or None, "input_dim": ... (optional)}, ...]}`` for a
    combination of stationary parts. Neither: a plain ``family`` kernel.
    ``mean_function``: ``"Constant"``, ``"LinearMapping"`` or ``"MLPMapping"``
    when the leaves carry one. ``device`` None means the card."""
    device = resolve_device(device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=dtype, device=device)

    def stationary(prefix, fam, input_dim, active_dims=None):
        fields = {"variance": t(prefix + "variance"), "lengthscale": t(prefix + "lengthscale")}
        if prefix + "power" in leaves:
            fields["power"] = t(prefix + "power")
        dims = None if active_dims is None else tuple(int(d) for d in active_dims)
        return FAMILY_CLASSES[fam](input_dim=input_dim, active_dims=dims, **fields)

    X = t("X")
    d = X.shape[-1]
    if composite is not None:
        parts = tuple(
            stationary(f"kern.parts.{i}.", part["family"],
                       part.get("input_dim", d if part.get("active_dims") is None
                                else len(part["active_dims"])),
                       part.get("active_dims"))
            for i, part in enumerate(composite["parts"]))
        cls = {"add": Add, "prod": Prod}[composite["op"]]
        kern = cls(parts=parts, input_dim=max(p.input_dim for p in parts))
    elif gower is not None:
        kern = Gower(input_dim=d, base=stationary("kern.base.", family, d),
                     ranges=t("kern.ranges"), cont_dims=tuple(gower["cont_dims"]),
                     disc_dims=tuple(gower["disc_dims"]),
                     gpy_compat=bool(gower["gpy_compat"]))
    else:
        kern = stationary("kern.", family, d)
    mf = None
    if mean_function is not None:
        fields = {name: t("mean_function." + name) for name in _MEAN_FIELDS[mean_function]}
        out_dim = fields.get("C", fields.get("A", fields.get("b2"))).shape[-1]
        mf = getattr(mean_functions, mean_function)(input_dim=d, output_dim=out_dim, **fields)
    noise = t("likelihood_variance")
    hint = leaves.get("jitter_hint")
    return GPRegression(kern=kern, likelihood_variance=noise, X=X,
                        Y=t("Y"), mask=t("mask") if "mask" in leaves else None,
                        mean_function=mf, heteroscedastic=noise.ndim == 1,
                        jitter_hint=None if hint is None else torch.tensor(
                            np.asarray(hint), dtype=torch.float32, device=device))


def leaves_of(model) -> dict[str, np.ndarray]:
    """The inverse map: leaf path -> numpy array."""
    return {path: t.detach().cpu().numpy() for path, t in named_leaves(model)}

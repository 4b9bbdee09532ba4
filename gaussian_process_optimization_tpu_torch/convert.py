"""Carry a model from the JAX package into the port.

The JAX model's leaves, given as numpy arrays keyed by their leaf path,
become a ``GPRegression`` of this package: a stationary kernel's
(``kern.variance``, ``kern.lengthscale``, optionally ``kern.power``) or a Gower
kernel's (``kern.base.variance``, ``kern.base.lengthscale``, ``kern.ranges``),
then ``likelihood_variance``, ``X``, ``Y``, optionally ``mask`` and
``jitter_hint``. The Gower kernel's static structure (continuous and discrete
columns, ``gpy_compat``) is passed beside the leaves. No JAX object is taken or
made.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import resolve_device
from .kernels.gower import Gower
from .kernels.stationary import FAMILY_CLASSES
from .models.gp import GPRegression
from .utils.tree import named_leaves


def gp_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "matern52",
                   gower: Mapping | None = None, dtype=torch.float64,
                   device=None) -> GPRegression:
    """``gower``: ``{"cont_dims": ..., "disc_dims": ..., "gpy_compat": ...}`` for a
    Gower kernel over a ``family`` base (the BO wrappers' kernel); None for a
    plain stationary kernel. ``device`` None means the card."""
    device = resolve_device(device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=dtype, device=device)

    X = t("X")
    prefix = "kern.base." if gower is not None else "kern."
    fields = {"variance": t(prefix + "variance"), "lengthscale": t(prefix + "lengthscale")}
    if prefix + "power" in leaves:
        fields["power"] = t(prefix + "power")
    kern = FAMILY_CLASSES[family](input_dim=X.shape[-1], **fields)
    if gower is not None:
        kern = Gower(input_dim=X.shape[-1], base=kern, ranges=t("kern.ranges"),
                     cont_dims=tuple(gower["cont_dims"]), disc_dims=tuple(gower["disc_dims"]),
                     gpy_compat=bool(gower["gpy_compat"]))
    hint = leaves.get("jitter_hint")
    return GPRegression(kern=kern, likelihood_variance=t("likelihood_variance"), X=X,
                        Y=t("Y"), mask=t("mask") if "mask" in leaves else None,
                        jitter_hint=None if hint is None else torch.tensor(
                            np.asarray(hint), dtype=torch.float32, device=device))


def leaves_of(model) -> dict[str, np.ndarray]:
    """The inverse map: leaf path -> numpy array."""
    return {path: t.detach().cpu().numpy() for path, t in named_leaves(model)}

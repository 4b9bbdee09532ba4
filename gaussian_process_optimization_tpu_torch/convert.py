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

The other models' leaves carry the same names under their own prefixes: a
sparse GP's add ``Z``; a warped GP's are the inner GP's under ``gp.`` and the
warp's under ``warp.`` (``d a b c`` for the tanh warp; ``a b lo hi`` for the
input warp). An MCMC surrogate is its point-estimate GP's leaves and the JAX
model's kept ``hmc_samples``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import resolve_device, resolve_dtype
from .kernels.base import Add, Prod
from .kernels.gower import Gower
from .kernels.stationary import FAMILY_CLASSES
from .models import mean_functions
from .models.gp import GPRegression
from .models.mcmc_bo_model import GPModel_MCMC
from .models.sparse import SparseGPRegression
from .models.warped import (IdentityWarp, InputWarpedGP, KumarWarp, LogWarp, TanhWarp,
                            WarpedGP)
from .utils.tree import named_leaves

_MEAN_FIELDS = {"Constant": ("C",), "LinearMapping": ("A",),
                "MLPMapping": ("W1", "b1", "W2", "b2")}


def gp_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "matern52",
                   gower: Mapping | None = None, composite: Mapping | None = None,
                   mean_function: str | None = None, dtype=None,
                   device=None) -> GPRegression:
    """``gower``: ``{"cont_dims": ..., "disc_dims": ..., "gpy_compat": ...}`` for a
    Gower kernel over a ``family`` base (the BO wrappers' kernel).
    ``composite``: ``{"op": "add" | "prod", "parts": [{"family": ...,
    "active_dims": ... or None, "input_dim": ... (optional)}, ...]}`` for a
    combination of stationary parts. Neither: a plain ``family`` kernel.
    ``mean_function``: ``"Constant"``, ``"LinearMapping"`` or ``"MLPMapping"``
    when the leaves carry one. ``device`` None means the card."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

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


def sparse_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "rbf",
                       inference: str = "vardtc", pep_alpha: float = 0.5, dtype=None,
                       device=None) -> SparseGPRegression:
    """A ``SparseGPRegression``: the exact GP's leaves and ``Z``."""
    gp = gp_from_leaves({k: v for k, v in leaves.items() if k != "Z"}, family,
                        dtype=dtype, device=device)
    Z = torch.tensor(np.asarray(leaves["Z"]), dtype=gp.X.dtype, device=gp.X.device)
    return SparseGPRegression(kern=gp.kern, likelihood_variance=gp.likelihood_variance, Z=Z,
                              X=gp.X, Y=gp.Y, mask=gp.mask, inference=inference,
                              pep_alpha=pep_alpha)


def _inner_gp(leaves, family, dtype, device):
    gp = gp_from_leaves({k[3:]: v for k, v in leaves.items() if k.startswith("gp.")}, family,
                        dtype=dtype, device=device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=gp.X.dtype, device=gp.X.device)
    return gp, t


def warped_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "matern52",
                       warp: str = "tanh", dtype=None, device=None) -> WarpedGP:
    """A ``WarpedGP``; ``warp`` is 'tanh' (leaves ``warp.d a b c``), 'log' or
    'identity' (no leaves)."""
    gp, t = _inner_gp(leaves, family, dtype, device)
    if warp == "tanh":
        w = TanhWarp(d=t("warp.d"), a=t("warp.a"), b=t("warp.b"), c=t("warp.c"))
    else:
        w = {"log": LogWarp, "identity": IdentityWarp}[warp]()
    return WarpedGP(gp=gp, warp=w)


def input_warped_from_leaves(leaves: Mapping[str, np.ndarray], dims, family: str = "matern52",
                             dtype=None, device=None) -> InputWarpedGP:
    """An ``InputWarpedGP`` warping the inputs ``dims``."""
    gp, t = _inner_gp(leaves, family, dtype, device)
    return InputWarpedGP(gp=gp, warp=KumarWarp(a=t("warp.a"), b=t("warp.b"), lo=t("warp.lo"),
                                               hi=t("warp.hi"), dims=tuple(int(d) for d in dims)))


def mcmc_from_samples(leaves: Mapping[str, np.ndarray], hmc_samples, family: str = "rbf",
                      dtype=None, device=None, **model_kwargs) -> GPModel_MCMC:
    """A ``GPModel_MCMC`` on the point-estimate GP of ``leaves`` with the JAX
    model's kept ``hmc_samples`` (S, P) as its samples; ``model_kwargs`` go to
    the model (``exact_feval`` decides which leaves the rows hold)."""
    gp = gp_from_leaves(leaves, family, dtype=dtype, device=device)
    model = GPModel_MCMC(dtype=gp.X.dtype, device=gp.X.device, **model_kwargs)
    model.set_samples(gp, hmc_samples)
    return model

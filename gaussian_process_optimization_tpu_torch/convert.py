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

Any kernel of the zoo, and any ``Add`` / ``Prod`` of them, is named by a spec
(:func:`kernel_from_leaves`): ``{"class": "StandardPeriodic", <static fields>}``,
its sub-kernels under their field names (``"parts": [spec, ...]`` for a
combination or ``Hierarchical``, ``"base"``, ``"kern"``, ``"split"``,
``"kernels"``), its leaves under the same paths as the JAX model's
(``kern.parts.1.W``). The coregionalized, grid and state-space models are
carried by ``multioutput_from_leaves`` (its GP's leaves), ``grid_from_leaves``
(``kerns.<i>.``, ``likelihood_variance``, ``axes.<i>``, ``Y``) and
``state_space_from_leaves``.

The approximate-inference models' leaves: an SVGP's ``kern.``, ``likelihood_variance``,
``Z``, ``q_mu``, ``q_sqrt_flat``, ``num_data``; a Laplace GP's ``kern.``, its
likelihood's under ``likelihood.`` (``deg_free sigma2`` for the Student-t, and so
on), ``X``, ``Y``; a classifier's ``kern.``, ``X``, ``Y`` and, if sparse, ``Z``; a
Student-t process's ``kern.``, ``deg_free``, ``X``, ``Y``. A likelihood is named by
its class (``"StudentT"``) and its link, where it has one, by the link's class.

The latent-variable models (``BayesianGPLVM``, ``MRD``, ``SSGPLVM``, ``SSMRD``,
``LVMOGP``, ``LVMOGP_MD``, ``BGPLVM_SVI``, ``IBPLFM``, ``GPOffsetRegression``) are
carried by :func:`latent_from_leaves`: each field from the leaf of its name, a
tuple field from ``<name>.<i>``, a kernel field from its spec; the point GPLVM
is a GPRegression (:func:`gp_from_leaves`).
"""
from __future__ import annotations

import dataclasses

from typing import Mapping

import numpy as np
import torch

from . import kernels as kernel_module
from .config import resolve_device, resolve_dtype
from .kernels.base import Kernel
from .kernels.stationary import FAMILY_CLASSES
from .models import bgplvm_svi, gplvm, ibp_lfm, lvmogp, mrd, ss_gplvm, zoo
from .models import likelihoods as likelihood_module
from .models import mean_functions
from .models.classification import GPClassification, SparseGPClassification
from .models.gp import GPRegression
from .models.laplace import GPLaplace
from .models.gp_grid import GPGridRegression
from .models.mcmc_bo_model import GPModel_MCMC
from .models.multioutput import GPCoregionalizedRegression
from .models.state_space import StateSpaceGP
from .models.sparse import SparseGPRegression
from .models.svgp import SVGP
from .models.tp import TPRegression
from .models.warped import (IdentityWarp, InputWarpedGP, KumarWarp, LogWarp, TanhWarp,
                            WarpedGP)
from .utils.tree import named_leaves

_MEAN_FIELDS = {"Constant": ("C",), "LinearMapping": ("A",),
                "MLPMapping": ("W1", "b1", "W2", "b2")}


# static flags of the port that the JAX kernels carry in their leaves' ranks
_RANK_FLAGS = {"ard": ("variances", "weight_variance"), "ard1": ("period",),
               "ard2": ("lengthscale",)}


def kernel_from_leaves(leaves: Mapping[str, np.ndarray], spec: Mapping, prefix: str = "kern.",
                       dtype=None, device=None) -> Kernel:
    """The kernel named by ``spec`` with its leaves from ``leaves[prefix + path]``.
    ``spec["class"]`` is a class name of ``kernels`` (``"Matern52"``,
    ``"Coregionalize"``, ``"Prod"``, ...); its other keys are static fields
    (``input_dim``, ``active_dims``, ``order``, ``n_freq``, ``output_dim``, a
    ``SymbolicKernel``'s ``expr`` as a torch callable, ...) or sub-kernel specs.
    ``device`` None means the card."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    cls = getattr(kernel_module, spec["class"])

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=dtype, device=device)

    def sub(value, path):
        if isinstance(value, Mapping) and "class" in value:
            return kernel_from_leaves(leaves, value, path + ".", dtype=dtype, device=device)
        return tuple(sub(v, f"{path}.{i}") for i, v in enumerate(value))

    fields = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        value = spec.get(f.name)
        if isinstance(value, (list, tuple)) and value and isinstance(value[0], Mapping):
            fields[f.name] = sub(value, key)
        elif isinstance(value, Mapping) and "class" in value:
            fields[f.name] = sub(value, key)
        elif key in leaves:
            fields[f.name] = t(key)
        elif f.name == "params":
            names = sorted(k[len(key) + 1:] for k in leaves if k.startswith(key + "."))
            fields["params"] = {n: t(f"{key}.{n}") for n in names}
        elif value is not None:
            fields[f.name] = (tuple(value) if isinstance(value, list) else value)
    for flag, names in _RANK_FLAGS.items():
        if flag in {f.name for f in dataclasses.fields(cls)} and flag not in spec:
            leaf = next(fields[n] for n in names if n in fields)
            fields[flag] = leaf.ndim >= 1
    if cls is kernel_module.SymbolicKernel:
        fields["shapes"] = tuple((k, tuple(v.shape)) for k, v in fields["params"].items())
    if "input_dim" not in fields:
        parts = [v for v in fields.values() if isinstance(v, Kernel)] + [
            k for v in fields.values() if isinstance(v, tuple) for k in v
            if isinstance(k, Kernel)]
        if parts:
            fields["input_dim"] = max(p.input_dim for p in parts)
    return cls(**fields)


def _composite_spec(composite, d):
    """The spec of ``gp_from_leaves``'s ``composite`` form."""
    parts = []
    for part in composite["parts"]:
        dims = part.get("active_dims")
        parts.append({"class": FAMILY_CLASSES[part["family"]].__name__,
                      "input_dim": part.get("input_dim", d if dims is None else len(dims)),
                      "active_dims": None if dims is None else [int(x) for x in dims]})
    return {"class": {"add": "Add", "prod": "Prod"}[composite["op"]], "parts": parts}


def gp_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "matern52",
                   gower: Mapping | None = None, composite: Mapping | None = None,
                   mean_function: str | None = None, kernel: Mapping | None = None,
                   dtype=None, device=None) -> GPRegression:
    """``kernel``: a spec (:func:`kernel_from_leaves`) of any zoo kernel.
    ``gower``: ``{"cont_dims": ..., "disc_dims": ..., "gpy_compat": ...}`` for a
    Gower kernel over a ``family`` base (the BO wrappers' kernel).
    ``composite``: ``{"op": "add" | "prod", "parts": [{"family": ...,
    "active_dims": ... or None, "input_dim": ... (optional)}, ...]}`` for a
    combination of stationary parts. None of these: a plain ``family`` kernel.
    ``mean_function``: ``"Constant"``, ``"LinearMapping"`` or ``"MLPMapping"``
    when the leaves carry one. ``device`` None means the card."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=dtype, device=device)

    X = t("X")
    d = X.shape[-1]
    if kernel is None and composite is not None:
        kernel = _composite_spec(composite, d)
    elif kernel is None and gower is not None:
        kernel = {"class": "Gower", "input_dim": d,
                  "cont_dims": tuple(int(i) for i in gower["cont_dims"]),
                  "disc_dims": tuple(int(i) for i in gower["disc_dims"]),
                  "gpy_compat": bool(gower["gpy_compat"]),
                  "base": {"class": FAMILY_CLASSES[family].__name__, "input_dim": d}}
    elif kernel is None:
        kernel = {"class": FAMILY_CLASSES[family].__name__, "input_dim": d}
    kern = kernel_from_leaves(leaves, kernel, dtype=dtype, device=device)
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


def multioutput_from_leaves(leaves: Mapping[str, np.ndarray], kernel: Mapping,
                            num_outputs: int, dtype=None,
                            device=None) -> GPCoregionalizedRegression:
    """A ``GPCoregionalizedRegression`` from its GP's leaves (``kern.``,
    ``likelihood_variance``, ``X``, ``Y``) and its kernel's spec."""
    gp = gp_from_leaves(leaves, kernel=kernel, dtype=dtype, device=device)
    return GPCoregionalizedRegression.from_model(gp, num_outputs)


def grid_from_leaves(leaves: Mapping[str, np.ndarray], kernels, dtype=None,
                     device=None) -> GPGridRegression:
    """A ``GPGridRegression``; ``kernels`` one spec per axis."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=dtype, device=device)

    return GPGridRegression(
        kerns=tuple(kernel_from_leaves(leaves, s, f"kerns.{i}.", dtype=dtype, device=device)
                    for i, s in enumerate(kernels)),
        likelihood_variance=t("likelihood_variance"),
        axes=tuple(t(f"axes.{i}") for i in range(len(kernels))), Y=t("Y"))


def state_space_from_leaves(leaves: Mapping[str, np.ndarray], family="matern32", order: int = 7,
                            dtype=None, device=None) -> StateSpaceGP:
    """A ``StateSpaceGP`` of ``family`` (a name, or a tuple for a sum)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    return StateSpaceGP(**{k: torch.tensor(np.asarray(leaves[k]), dtype=dtype, device=device)
                           for k in ("variance", "lengthscale", "noise_variance", "period",
                                     "lengthscale_damp", "X", "Y")},
                        family=tuple(family) if isinstance(family, list) else family,
                        order=order)


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


def _placed(leaves, dtype, device):
    """(t(key) -> a tensor on the device, the kernel of ``kern.`` leaves)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), dtype=dtype, device=device)

    def kern(family, d):
        fields = {"variance": t("kern.variance"), "lengthscale": t("kern.lengthscale")}
        if "kern.power" in leaves:
            fields["power"] = t("kern.power")
        return FAMILY_CLASSES[family](input_dim=d, **fields)

    return t, kern


def likelihood_from_leaves(leaves: Mapping[str, np.ndarray], name: str, link: str | None = None,
                           prefix: str = "likelihood.", dtype=None, device=None):
    """A likelihood of class ``name`` from its leaves under ``prefix``; an
    integer leaf (``output_index``) stays integer. ``link`` names the link
    class of a linked likelihood."""
    t, _ = _placed(leaves, dtype, device)
    cls = getattr(likelihood_module, name)
    fields = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if f.name == "gp_link":
            fields["gp_link"] = getattr(likelihood_module, link)()
        elif key in leaves:
            v = np.asarray(leaves[key])
            fields[f.name] = (torch.tensor(v, device=t(key).device) if v.dtype.kind in "iu"
                              else t(key))
    return cls(**fields)


def svgp_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "rbf", dtype=None,
                     device=None) -> SVGP:
    """An ``SVGP`` with the closed-form Gaussian likelihood."""
    t, kern = _placed(leaves, dtype, device)
    Z = t("Z")
    return SVGP(kern=kern(family, Z.shape[-1]), likelihood_variance=t("likelihood_variance"),
                Z=Z, q_mu=t("q_mu"), q_sqrt_flat=t("q_sqrt_flat"), num_data=t("num_data"))


def laplace_from_leaves(leaves: Mapping[str, np.ndarray], likelihood: str = "Bernoulli",
                        link: str | None = None, family: str = "rbf", dtype=None,
                        device=None) -> GPLaplace:
    """A ``GPLaplace`` with the likelihood of class ``likelihood``."""
    t, kern = _placed(leaves, dtype, device)
    X = t("X")
    return GPLaplace(kern=kern(family, X.shape[-1]),
                     likelihood=likelihood_from_leaves(leaves, likelihood, link, dtype=X.dtype,
                                                       device=X.device), X=X, Y=t("Y"))


def classification_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "rbf",
                               inference_mode: str = "parallel", max_sweeps: int = 60,
                               dtype=None, device=None):
    """A ``GPClassification``, or a ``SparseGPClassification`` when the
    leaves carry ``Z``."""
    t, kern = _placed(leaves, dtype, device)
    X = t("X")
    common = dict(kern=kern(family, X.shape[-1]), X=X, Y=t("Y"), inference_mode=inference_mode,
                  max_sweeps=max_sweeps)
    if "Z" in leaves:
        return SparseGPClassification(Z=t("Z"), **common)
    return GPClassification(**common)


def tp_from_leaves(leaves: Mapping[str, np.ndarray], family: str = "rbf", dtype=None,
                   device=None) -> TPRegression:
    """A ``TPRegression``."""
    t, kern = _placed(leaves, dtype, device)
    X = t("X")
    return TPRegression(kern=kern(family, X.shape[-1]), deg_free=t("deg_free"), X=X, Y=t("Y"))


_LATENT = {cls.__name__: cls for cls in (
    gplvm.BayesianGPLVM, mrd.MRD, ss_gplvm.SSGPLVM, ss_gplvm.SSMRD, lvmogp.LVMOGP,
    lvmogp.LVMOGP_MD, bgplvm_svi.BGPLVM_SVI, ibp_lfm.IBPLFM, zoo.GPOffsetRegression)}


def latent_from_leaves(name: str, leaves: Mapping[str, np.ndarray], kernels: Mapping,
                       dtype=None, device=None, **static):
    """The latent-variable model of class ``name`` (a key of ``_LATENT``) from
    its leaves. ``kernels`` maps each kernel field (``kern``, ``kern_c``,
    ``kern_r``) to its spec, or ``kerns`` to a list of specs, one per view.
    Integer leaves (``out_idx``, ``sel``) stay integer; ``static`` gives the
    static fields (``pi``, ``alpha``)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)

    def t(key):
        v = np.asarray(leaves[key])
        if v.dtype.kind in "iu":
            return torch.tensor(v, device=device)
        return torch.tensor(v, dtype=dtype, device=device)

    fields = dict(static)
    for f in dataclasses.fields(_LATENT[name]):
        spec = kernels.get(f.name)
        if isinstance(spec, (list, tuple)):
            fields[f.name] = tuple(kernel_from_leaves(leaves, s, f"{f.name}.{i}.", dtype=dtype,
                                                      device=device) for i, s in enumerate(spec))
        elif spec is not None:
            fields[f.name] = kernel_from_leaves(leaves, spec, f.name + ".", dtype=dtype,
                                                device=device)
        elif f.name in leaves:
            fields[f.name] = t(f.name)
        elif f"{f.name}.0" in leaves:
            n = sum(1 for k in leaves if k.startswith(f.name + ".") and k.count(".") == 1)
            fields[f.name] = tuple(t(f"{f.name}.{i}") for i in range(n))
    return _LATENT[name](**fields)

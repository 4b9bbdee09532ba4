"""What the harness reads from the program's own state once a window has
closed: the last round's predictions at its suggestions, and the fit's -LML
value and gradient at the fitted hyperparameters over the fit's restart
lanes, through the same ``Fitter`` objective the fit runs."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaf(obj, name):
    """The tensor field ``name`` of a kernel, searched depth first through
    the kernels it wraps."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name == name and isinstance(v, torch.Tensor):
            return v
        if dataclasses.is_dataclass(v):
            found = _leaf(v, name)
            if found is not None:
                return found
    return None


def parameters(bo, names) -> tuple[dict, float]:
    """({name: values} of the fitted kernel's parameters ``names``, the
    likelihood variance)."""
    gp = bo.model.model
    values = {n: _leaf(gp.kern, n).detach().double().cpu().numpy().reshape(-1) for n in names}
    return values, float(gp.likelihood_variance)


def lanes(port, bo, cfg: dict):
    """(fitter, model, U): the fitted hyperparameters packed as the fit packs
    them, repeated over the fit's restart lanes."""
    gp = bo.model.model
    fix = ("likelihood_variance",) if cfg["bo"].get("exact_feval") else ()
    fitter = port.Fitter(gp, num_restarts=cfg["bo"]["optimize_restarts"],
                         maxiter=cfg["bo"]["max_iters"], fix=fix)
    U = fitter.packer.pack(gp).detach()
    return fitter, gp, U.expand(fitter.num_restarts, -1).clone()


def value_and_grad(fitter, gp, U):
    """The fit's objective -(LML) per lane and its gradient in the packed
    coordinates, shape (lanes, n)."""
    Ug = U.clone().requires_grad_(True)
    with torch.enable_grad():
        f = fitter.objective(Ug, gp)
        (g,) = torch.autograd.grad(f.sum(), Ug)
    return f.detach(), g


def packed_names(values: dict, U) -> list[str]:
    """The name of each packed coordinate: the kernel's trainable parameters
    in the fit's order, checked against the packed values (softplus)."""
    names = [n for n, v in values.items() for _ in range(v.size)]
    flat = np.concatenate([values[n] for n in values])
    packed = torch.nn.functional.softplus(U[0].detach().double(), threshold=30).cpu().numpy()
    if len(names) != U.shape[-1] or not np.allclose(packed, flat, rtol=1e-4, atol=1e-12):
        raise RuntimeError(f"packed coordinates {packed} are not the parameters {values}")
    return names

"""Default parameterization rules (twin of ``gaussian_process_optimization_tpu/models/parameters.py``):
which leaves are trainable, and under which transform, by field name. The name
is the leaf's last attribute name, so ``variance`` of every part of an ``Add``
gets the same transform."""
from __future__ import annotations

from ..utils.packing import Packer
from ..utils.transforms import IDENTITY, POSITIVE, Logistic
from ..utils.tree import leaf_name, named_leaves

POSITIVE_NAMES = {
    "variance", "variances", "lengthscale", "likelihood_variance", "power",
    "weight_variance", "bias_variance", "kappa", "period", "noise_variance",
    "tau", "a", "b", "d",
}

DATA_NAMES = {
    "X", "Y", "mask", "ranges", "fixed_K", "mean", "std",
    "L", "alpha", "jitter", "ok", "lml",
    "lo", "hi", "num_data",
    "jitter_hint",
}


def leaf_names(model) -> list[str]:
    """Field name of each leaf (the last attribute name of its path)."""
    return [leaf_name(path) for path, _ in named_leaves(model)]


def make_packer(model, fix: tuple = (), train_only: tuple | None = None,
                transform_overrides: dict | None = None) -> Packer:
    """Packer with the reference's defaults (``make_packer``, parameters.py:59):
    data leaves fixed, positive leaves through softplus. ``fix`` freezes more
    fields by name (the noise under GPyOpt's ``exact_feval``); ``train_only``,
    if given, names the only trainable fields; ``transform_overrides`` maps a
    field name to its transform (the bounded noise otherwise)."""
    names = leaf_names(model)
    overrides = transform_overrides or {}
    transforms = [overrides.get(name, POSITIVE if name in POSITIVE_NAMES else IDENTITY)
                  for name in names]
    if train_only is not None:
        fixed = [name not in train_only for name in names]
    else:
        fixed = [name in DATA_NAMES or name in fix for name in names]
    return Packer(model, transforms=transforms, fixed=fixed)


def bounded_noise_transform(lo: float = 1e-9, hi: float = 1e6) -> Logistic:
    """GPyOpt's noise bound when ``exact_feval`` is off (gpmodel.py:74-76)."""
    return Logistic(lo=lo, hi=hi)

"""Default parameterization rules (twin of ``gaussian_process_optimization_tpu/models/parameters.py``):
which leaves are trainable, and under which transform, by field name."""
from __future__ import annotations

from ..utils.packing import Packer
from ..utils.transforms import IDENTITY, POSITIVE, Logistic
from ..utils.tree import named_leaves

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
    """Field name of each leaf (the last path component)."""
    return [path.rsplit(".", 1)[-1] for path, _ in named_leaves(model)]


def make_packer(model, fix: tuple = (), transform_overrides: dict | None = None) -> Packer:
    """Packer with the reference's defaults (``make_packer``, parameters.py:59):
    data leaves fixed, positive leaves through softplus. ``fix`` freezes more
    fields by name (the noise under GPyOpt's ``exact_feval``);
    ``transform_overrides`` maps a field name to its transform (the bounded
    noise otherwise). The reference's ``train_only`` is not ported."""
    names = leaf_names(model)
    overrides = transform_overrides or {}
    transforms = [overrides.get(name, POSITIVE if name in POSITIVE_NAMES else IDENTITY)
                  for name in names]
    fixed = [name in DATA_NAMES or name in fix for name in names]
    return Packer(model, transforms=transforms, fixed=fixed)


def bounded_noise_transform(lo: float = 1e-9, hi: float = 1e6) -> Logistic:
    """GPyOpt's noise bound when ``exact_feval`` is off (gpmodel.py:74-76)."""
    return Logistic(lo=lo, hi=hi)

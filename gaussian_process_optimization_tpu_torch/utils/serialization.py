"""Model and BO-state serialization (twin of
``gaussian_process_optimization_tpu/utils/serialization.py``).

- GPy's models save to (gzipped) JSON through to_dict / from_dict (core/model.py:60-88,
  core/gp.py:112): ``to_dict`` / ``from_dict`` / ``save_model`` / ``load_model``
  here walk this package's dataclasses (the class path and the fields; a
  tensor as its dtype, shape and values) and load the tensors on a named
  device, the card when none is named.
- The application resumes from its (X, Y) history (run.py:833-914):
  ``save_bo_state`` / ``load_bo_state`` write and read an ``.npz`` of X, Y and
  the surrogate's hyperparameters in ``get_model_parameters``' order, plain
  arrays, the JAX package's format.
"""
from __future__ import annotations

import dataclasses
import gzip
import importlib
import json

import numpy as np
import torch

from ..config import resolve_device

_PKG = "gaussian_process_optimization_tpu_torch"


def to_dict(obj):
    """A dataclass model as a JSON-able dict (class path and fields)."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__class__": f"{type(obj).__module__}.{type(obj).__qualname__}",
                "fields": {f.name: to_dict(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": type(obj).__name__, "items": [to_dict(x) for x in obj]}
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "dtype": str(obj.dtype).removeprefix("torch."),
                "shape": list(obj.shape), "data": obj.detach().cpu().reshape(-1).tolist()}
    if isinstance(obj, np.ndarray):
        return {"__array__": True, "dtype": str(obj.dtype), "data": obj.tolist()}
    return obj


def from_dict(d, device=None):
    """The inverse of :func:`to_dict`; tensors land on ``device`` (the card
    when None). Only classes of this package are instantiated: a checkpoint
    names classes to build with its own arguments."""
    device = resolve_device(device)

    def build(v):
        if isinstance(v, dict) and "__class__" in v:
            mod_name, _, cls_name = v["__class__"].rpartition(".")
            if not (mod_name == _PKG or mod_name.startswith(_PKG + ".")):
                raise ValueError(f"refusing to instantiate {v['__class__']!r}: only classes "
                                 f"under {_PKG}.* may appear in checkpoints")
            cls = importlib.import_module(mod_name)
            for part in cls_name.split("."):
                cls = getattr(cls, part)
            return cls(**{k: build(x) for k, x in v["fields"].items()})
        if isinstance(v, dict) and "__seq__" in v:
            items = [build(x) for x in v["items"]]
            return tuple(items) if v["__seq__"] == "tuple" else items
        if isinstance(v, dict) and v.get("__tensor__"):
            return torch.tensor(v["data"], dtype=getattr(torch, v["dtype"]),
                                device=device).reshape(v["shape"])
        if isinstance(v, dict) and v.get("__array__"):
            return np.asarray(v["data"], dtype=v["dtype"])
        return v

    return build(d)


def save_model(model, path, compress=True):
    """JSON, gzipped by default or for a ``.gz`` path (GPy Model._save_model,
    core/model.py:60)."""
    payload = json.dumps(to_dict(model)).encode()
    opener = gzip.open if compress or str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(payload)


def load_model(path, device=None):
    """A model saved by :func:`save_model`, its tensors on ``device``."""
    try:
        with gzip.open(path, "rb") as fh:
            payload = fh.read()
    except gzip.BadGzipFile:
        with open(path, "rb") as fh:
            payload = fh.read()
    return from_dict(json.loads(payload.decode()), device=device)


def save_bo_state(bo, path):
    """The resumable BO state, (X, Y) and the surrogate's hyperparameters
    (the reference's spreadsheet persistence, run.py:749-914)."""
    params = None
    if getattr(bo, "model", None) is not None and getattr(bo.model, "model", None) is not None:
        params = bo.model.get_model_parameters()[0]
    np.savez(path, X=np.asarray(bo.X), Y=np.asarray(bo.Y),
             params=params if params is not None else np.zeros(0))


def load_bo_state(path):
    """(X, Y, params); a BO built with X=X, Y=Y resumes the run (ask-tell), as
    the reference's spreadsheet reload does."""
    with np.load(path) as d:
        return d["X"], d["Y"], d["params"]

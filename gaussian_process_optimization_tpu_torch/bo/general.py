"""GPyOpt ``util/general.py``'s host helpers (twin of
``gaussian_process_optimization_tpu/bo/general.py``; general.py:9-230): numpy
conveniences on the surrogates of this package. ``get_quantiles`` lives in
``bo/acquisitions.py`` and 'stats' normalization in ``utils/normalizer.py``.
"""
from __future__ import annotations

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy().astype(float) if isinstance(a, torch.Tensor) else \
        np.asarray(a, dtype=float)


def reshape(x, input_dim):
    """x as a matrix with input_dim columns (general.py:76)."""
    x = np.asarray(x, dtype=float)
    if x.size == input_dim:
        x = x.reshape((1, input_dim))
    return x


def _train_X(model):
    """Training inputs of a surrogate: a BO wrapper (its padded inner
    ``.model`` and mask) or a bare model with ``.X``."""
    inner = getattr(model, "model", model)
    X = _np(inner.X)
    mask = getattr(inner, "mask", None)
    if mask is not None:
        X = X[_np(mask) > 0]
    return X


def _bare(model, x):
    return torch.as_tensor(x, dtype=model.X.dtype, device=model.X.device)


def get_moments(model, x):
    """(mean, sd, fmin at the training X) of a surrogate at x (general.py:86).
    A BO wrapper's predict gives sd (GPyOpt's convention), a bare model's the
    variance; the wrapper is told by its ``get_fmin``."""
    X = _train_X(model)
    x = reshape(x, X.shape[1])
    if hasattr(model, "get_fmin"):
        m, s = model.predict(x)
        return _np(m), _np(s), float(model.get_fmin())
    with torch.no_grad():
        fmin = float(np.min(_np(model.predict(_bare(model, X))[0])))
        m, v = model.predict(_bare(model, x))
    return _np(m), np.sqrt(np.clip(_np(v), 0.0, np.inf)), fmin


def get_d_moments(model, x):
    """Gradients of (mean, sd) in x (general.py:98): a BO wrapper's
    ``predict_withGradients``, or a bare model's ``predictive_gradients``
    with dsdx = dvdx / (2 s)."""
    x = reshape(x, _train_X(model).shape[1])
    if hasattr(model, "predict_withGradients"):
        _, _, dmdx, dsdx = model.predict_withGradients(x)
        return _np(dmdx), _np(dsdx)
    xt = _bare(model, x)
    with torch.no_grad():
        _, v = model.predict(xt)
    dmdx, dvdx = model.predictive_gradients(xt)
    dsdx = _np(dvdx) / (2.0 * np.sqrt(np.clip(_np(v), 1e-20, np.inf)))
    return _np(dmdx)[:, :, 0], dsdx


def best_value(Y, sign=1):
    """Running best: min (sign=1) or max of Y[:i+1] (general.py:131)."""
    Y = np.asarray(Y, dtype=float).reshape(-1)
    return (np.minimum if sign == 1 else np.maximum).accumulate(Y)


def best_guess(f, X):
    """Running best of f over growing prefixes of X (general.py:49)."""
    return np.minimum.accumulate(np.asarray(f(np.asarray(X)), dtype=float).reshape(-1))


def samples_multidimensional_uniform(bounds, num_data, rng=None):
    """Uniform samples in a box (general.py:63); ``rng`` a numpy Generator."""
    rng = np.random.default_rng() if rng is None else rng
    lo = np.asarray([b[0] for b in bounds], dtype=float)
    hi = np.asarray([b[1] for b in bounds], dtype=float)
    return rng.uniform(lo, hi, size=(num_data, len(bounds)))


def values_to_array(input_values):
    """int / float / tuple / array -> 2-D numpy array (general.py:168)."""
    if isinstance(input_values, tuple):
        return np.array(input_values, dtype=float).reshape(-1, 1)
    if isinstance(input_values, np.ndarray):
        return np.atleast_2d(input_values)
    if isinstance(input_values, (int, float, np.integer, np.floating)):
        return np.atleast_2d(np.array(input_values, dtype=float))
    raise TypeError(f"cannot convert {type(input_values).__name__} to array")


def merge_values(values1, values2):
    """Every row combination of two arrays (general.py:183)."""
    a1, a2 = values_to_array(values1), values_to_array(values2)
    if a1.size == 0:
        return a2
    if a2.size == 0:
        return a1
    return np.atleast_2d([np.hstack((r1, r2)) for r1 in a1 for r2 in a2])


def normalize(Y, normalization_type="stats"):
    """1-D 'stats' (zero mean, unit sd) or 'maxmin' (into [0, 1])
    normalization (general.py:203)."""
    Y = np.asarray(Y, dtype=float)
    if np.max(Y.shape) != Y.size:
        raise NotImplementedError("Only 1-dimensional arrays are supported.")
    shape = Y.shape
    Y = Y.reshape(-1)
    if normalization_type == "stats":
        Y_norm = Y - Y.mean()
        std = Y.std()
        if std > 0:
            Y_norm = Y_norm / std
    elif normalization_type == "maxmin":
        Y_norm = Y - Y.min()
        y_range = np.ptp(Y)
        if y_range > 0:
            Y_norm = Y_norm / y_range
    else:
        raise ValueError(f"Unknown normalization type: {normalization_type}")
    return Y_norm.reshape(shape)


def compute_integrated_acquisition(acquisition, x):
    """The acquisition averaged over the model's hyperparameter samples
    (general.py:9). The MCMC acquisitions (``bo/acquisitions_mcmc.py``)
    already average over their samples, and a point-estimate acquisition has
    one sample, so this is ``acquisition_function`` (GPyOpt's loop sets each
    sample on the model in turn)."""
    return acquisition.acquisition_function(x)


def compute_integrated_acquisition_withGradients(acquisition, x):
    """As :func:`compute_integrated_acquisition`, with the gradients
    (general.py:26)."""
    return acquisition.acquisition_function_withGradients(x)

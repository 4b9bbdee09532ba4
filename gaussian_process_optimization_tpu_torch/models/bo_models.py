"""BO surrogate wrapper (twin of ``gaussian_process_optimization_tpu/models/bo_models.py``;
GPyOpt models/gpmodel.py:9 ``GPModel``).

The GPyOpt-side conventions: ``predict`` returns (mean, std) with the variance
floored at 1e-10 (gpmodel.py:99-102); ``get_fmin`` is the smallest posterior
mean at the training inputs (:125); the default kernel is Matern52, Gower-wrapped
with the design space's continuous ranges when ``Gower`` is set (:58); the
default noise is var(Y) * 0.01 (:64), fixed at 1e-6 under ``exact_feval`` and
bounded to [1e-9, 1e6] otherwise (:72-76); ``updateModel`` refits by
multi-restart L-BFGS (:88-93).

As in the reference, the data sit in buffers padded to a power of two with a
mask, and the jitter ladder is warm-started across refits: fit trials run the
greedy ladder from ``jitter_hint``, the posterior re-verifies the minimal rung,
and that rung is the next refit's hint. ``ladder`` records, per refit, the
hint the fit started from and the posterior's rung.

``mean_function`` and ``priors`` (field name -> Prior, ``models/fit.py``) go
to the model and to its fits; ``optimizer`` and ``verbose`` are GPyOpt's
arguments, kept and unused (the fit is this package's L-BFGS).

Tensors live on ``device`` (the card unless another is named) in ``dtype``
(float32 on the card and float64 on the CPU unless another is named);
fit restarts draw from ``generator`` (a ``torch.Generator`` on that device,
seeded from ``seed`` by default). With a ``mesh`` (``parallel/sharded.Mesh``)
the restarts shard over its ``'data'`` axis
(``sharded.make_sharded_multistart_fit``): ceil(optimize_restarts / shards)
per shard, so the total rounds up to a multiple of the axis size.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.gower import Gower
from ..kernels.stationary import Matern52
from ..parallel import sharded
from .fit import Fitter
from .gp import GPRegression
from ..utils.tree import leaf_name, named_leaves
from .parameters import bounded_noise_transform
from ..utils.profiling import host, span


def _bucket(n: int, minimum: int = 16) -> int:
    """Power-of-two padding bucket (bo_models.py:35)."""
    return max(minimum, 2 ** math.ceil(math.log2(max(n, 1))))


class BOModel:
    """The surrogate interface of the BO loop (GPyOpt models/base.py)."""

    analytical_gradient_prediction = False
    MCMC_sampler = False

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        raise NotImplementedError

    def predict(self, X):
        raise NotImplementedError

    def predict_withGradients(self, X):
        raise NotImplementedError

    def get_fmin(self):
        raise NotImplementedError


class GPModel(BOModel):
    """Exact, padded GP surrogate (GPyOpt gpmodel.py:9)."""

    analytical_gradient_prediction = True

    def __init__(self, kernel=None, noise_var=None, exact_feval=False, optimizer="lbfgs",
                 max_iters=1000, optimize_restarts=5, verbose=False, ARD=False, Gower=False,
                 space=None, mean_function=None, seed=0, mesh=None, *, priors=None,
                 device=None, dtype=None, generator=None):
        self.kernel_template = kernel
        self.noise_var = noise_var
        self.exact_feval = exact_feval
        self.optimizer_name = optimizer
        self.max_iters = max_iters
        self.optimize_restarts = optimize_restarts
        self.verbose = verbose
        self.mean_function = mean_function
        self.priors = priors
        self.ARD = ARD
        self.Gower = Gower
        self.space = space
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.generator = generator
        self.mesh = sharded.check_mesh(mesh)
        self.model: GPRegression | None = None
        self.posterior = None
        self.ladder: list[dict] = []
        self._fitters: dict = {}
        self._fmin = None

    @classmethod
    def from_fitted(cls, model: GPRegression, posterior=None, **kwargs) -> "GPModel":
        """The surrogate around an already fitted ``model`` (on its device, in
        its dtype), with its posterior (``Li`` precomputed unless given)."""
        out = cls(device=model.X.device, dtype=model.X.dtype, **kwargs)
        out.model = model
        with torch.no_grad():
            out.posterior = (posterior if posterior is not None
                             else model.inference(precompute_inverse=True))
        return out

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, dtype=float), dtype=self.dtype,
                               device=self.device)

    def _default_kernel(self, input_dim):
        """Matern52 (ARD if asked), Gower-wrapped with the space's continuous
        ranges (bo_models.py:134-155). The kernel slices model-space X, so the
        column indices come from the model-space slices; one-hot categorical
        columns take the discrete (Hamming) branch."""
        base = Matern52.create(input_dim, variance=1.0, ARD=self.ARD, dtype=self.dtype,
                               device=self.device)
        if not (self.Gower and self.space is not None):
            return base
        cont, disc = [], []
        for v, sl in zip(self.space.space_expanded, self.space._model_slices):
            (cont if v.is_continuous else disc).extend(range(sl.start, sl.stop))
        return Gower.create(base, ranges=self.space.lengthscales(), cont_dims=cont,
                            disc_dims=disc, gpy_compat=True)

    def _create_model(self, X, Y, max_points):
        noise = default_noise(self.noise_var, self.exact_feval, Y)
        kern = self.kernel_template
        if kern is None:
            kern = self._default_kernel(X.shape[1])
        model = GPRegression.create(X, Y, kernel=kern, noise_var=noise,
                                    mean_function=self.mean_function,
                                    max_points=max_points, dtype=self.dtype,
                                    device=self.device)
        self.model = dataclasses.replace(
            model, jitter_hint=torch.zeros((), dtype=torch.float32, device=self.device),
            jitter_greedy=True)

    def _fitter_for(self, bucket):
        if bucket not in self._fitters:
            if self.exact_feval:
                fix, overrides = ("likelihood_variance",), None
            else:
                fix, overrides = (), {"likelihood_variance": bounded_noise_transform()}
            kw = dict(maxiter=self.max_iters, fix=fix, transform_overrides=overrides,
                      priors=self.priors)
            if self.mesh is None:
                self._fitters[bucket] = Fitter(self.model, num_restarts=self.optimize_restarts,
                                               **kw)
            else:
                per_shard = max(1, -(-self.optimize_restarts // self.mesh.shape["data"]))
                self._fitters[bucket] = sharded.make_sharded_multistart_fit(
                    self.model, self.mesh, restarts_per_device=per_shard, **kw)
        return self._fitters[bucket]

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        """Refit on all data (gpmodel.py:78-93, bo_models.py:206-237)."""
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all), -1)
        bucket = _bucket(X_all.shape[0])
        if self.model is None:
            self._create_model(X_all, Y_all, max_points=bucket)
        else:
            self.model = self.model.with_data(X_all, Y_all, max_points=bucket)
        hint = self.model.jitter_hint
        if self.max_iters > 0:
            self.model, _ = self._fitter_for(bucket)(self.model, self.generator)
        # the posterior re-verifies the minimal rung; it is the next refit's hint
        with span("gp.posterior"), torch.no_grad():
            self.posterior = dataclasses.replace(self.model, jitter_greedy=False).inference(
                precompute_inverse=True)
        self.model = dataclasses.replace(self.model,
                                         jitter_hint=self.posterior.rung.to(torch.float32))
        self.ladder.append({"fit_hint": int(host(hint)),
                            "posterior_rung": int(host(self.posterior.rung))})
        self._fmin = None

    def predict(self, X):
        """(mean, std) as numpy, the variance floored at 1e-10 (gpmodel.py:102-124)."""
        with torch.no_grad():
            mu, v = self.model.predict(self._tensor(np.atleast_2d(X)), posterior=self.posterior)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        return mu.cpu().numpy(), s.cpu().numpy()

    def predict_covariance(self, X):
        """The full predictive covariance at ``X``, as numpy."""
        with torch.no_grad():
            _, cov = self.model.predict(self._tensor(np.atleast_2d(X)), full_cov=True,
                                        posterior=self.posterior)
        return cov.cpu().numpy()

    def predict_withGradients(self, X):
        """(m, s, dm/dx, ds/dx) as numpy; ds = dv/dx / (2 s) (gpmodel.py:131-141)."""
        X = self._tensor(np.atleast_2d(X))
        with torch.no_grad():
            mu, v = self.model.predict(X, posterior=self.posterior)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
        dm, dv = self.model.predictive_gradients(X, posterior=self.posterior)
        return tuple(t.cpu().numpy() for t in (mu, s, dm[:, :, 0], dv / (2.0 * s)))

    def get_fmin(self) -> float:
        """Smallest posterior mean at the real training rows (gpmodel.py:125-129),
        cached per refit."""
        if self._fmin is None:
            with torch.no_grad():
                self._fmin = float(host(masked_fmin(self.model, self.posterior)))
        return self._fmin

    def Y_min(self) -> float:
        return real_Y_min(self.model)

    def get_model_parameters(self):
        """The kernel's leaves and the noise as one ``(1, n)`` row (gpmodel.py:143)."""
        return parameter_rows(self.model.kern, self.model.likelihood_variance, lanes=1)

    def get_model_parameters_names(self):
        return parameter_names(self.model.kern, self.model.likelihood_variance)

    def device_state(self):
        """(model, posterior, fmin) for the acquisitions' tensor code."""
        fmin = torch.tensor(self.get_fmin(), dtype=self.dtype, device=self.device)
        return self.model, self.posterior, fmin


@dataclasses.dataclass(frozen=True)
class _Parameters:
    """(kernel, noise): what ``get_model_parameters`` reports."""

    kern: object = None
    noise: torch.Tensor = None


def parameter_rows(kern, noise, lanes: int = 1, like=None) -> np.ndarray:
    """The kernel's leaves and the noise, ``(lanes, n)``: one row per lane of a
    lane-batched model. A leaf with no more axes than its counterpart in
    ``like``, a model without lanes (a fixed noise, say), is repeated."""
    leaves = [t for _, t in named_leaves(_Parameters(kern, noise))]
    ref = leaves if like is None else [t for _, t in named_leaves(_Parameters(*like))]
    rows = []
    for t, r in zip(leaves, ref):
        a = t.detach().cpu().numpy()
        if like is not None and a.ndim == r.ndim:
            a = np.broadcast_to(a, (lanes,) + a.shape)
        rows.append(a.reshape(lanes, -1))
    return np.concatenate(rows, axis=1)


def parameter_names(kern, noise) -> list[str]:
    """One name per leaf, as the reference's: the leaf's last attribute name
    ('' for the noise, which stands alone beside the kernel)."""
    return [leaf_name(path) if path.startswith("kern") else ""
            for path, _ in named_leaves(_Parameters(kern, noise))]


def masked_fmin(gp, posterior) -> torch.Tensor:
    """Smallest posterior mean over the real training rows, one per lane
    (``lanes``-shaped; a scalar without lanes)."""
    mu = gp.predict_mean(gp.X, posterior)
    if gp.mask is not None:
        mu = torch.where(gp.mask[:, None] > 0, mu, torch.full_like(mu, float("inf")))
    return torch.amin(mu, dim=(-2, -1))


def real_Y_min(gp) -> float:
    """Smallest real training target, LP's ``Min`` (batch_local_penalization.py:44)."""
    Y = gp.Y if gp.mask is None else gp.Y[gp.mask > 0]
    return float(host(Y.min()))


def default_noise(noise_var, exact_feval, Y) -> float:
    """GPyOpt's noise: the given one, else var(Y) * 0.01, and 1e-6 under
    ``exact_feval`` (gpmodel.py:64-72)."""
    if exact_feval:
        return 1e-6
    return noise_var if noise_var is not None else float(np.var(Y)) * 0.01

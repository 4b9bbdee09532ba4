"""The small wrappers that complete GPy's models/ directory (twin of
``gaussian_process_optimization_tpu/models/zoo.py``):

- GPHeteroscedasticRegression (gp_heteroscedastic_regression.py:11): the exact
  GP with one noise variance per row.
- GPKroneckerGaussianRegression (gp_kronecker_gaussian_regression.py): K =
  kron(K2, K1) + noise over a grid, through ``models/gp_grid.py``.
- GPVariationalGaussianApproximation (gp_var_gauss.py:10) over
  ``models/var_gauss.py``.
- OneVsAllClassification / OneVsAllSparseClassification
  (one_vs_all_classification.py:8, one_vs_all_sparse_classification.py:8).
- fit_bcgplvm (bcgplvm.py:10): the back-constrained GPLVM, X = g(Y) with the
  mapping's parameters trained through the LML.
- fit_sparse_gplvm (sparse_gplvm.py:9): the VarDTC bound over the
  hyperparameters, Z and X.
- GPOffsetRegression (gp_offset_regression.py:11): a trainable input offset per
  cluster, the last input column naming the cluster.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from .classification import GPClassification, SparseGPClassification
from .gp import GPRegression
from .gp_grid import GPGridRegression
from .gplvm import gplvm_packer, minimize_one, pca_init
from .mean_functions import MLPMapping
from .parameters import make_packer
from .sparse import SparseGPRegression


def GPHeteroscedasticRegression(X, Y, kernel=None, noise_vars=None, dtype=None, device=None):
    """The exact GP with one noise variance per row, 1.0 each unless given."""
    X = np.atleast_2d(np.asarray(X, dtype=float))
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    kernel = kernel or RBF.create(X.shape[1], dtype=dtype, device=device)
    noise = np.ones(X.shape[0]) if noise_vars is None else np.asarray(noise_vars, dtype=float)
    return GPRegression.create(X, Y, kernel=kernel, noise_var=noise, dtype=dtype, device=device)


def GPKroneckerGaussianRegression(X1, X2, Y, kern1, kern2, noise_var=1.0, dtype=None,
                                  device=None):
    """K = kron(K2, K1) + s2 I over the X1 x X2 grid, Y[i, j] = y(X1[i], X2[j])."""
    return GPGridRegression.create([X1, X2], Y, kernels=[kern1, kern2], noise_var=noise_var,
                                   dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class GPVariationalGaussianApproximation:
    """The KL-variational Gaussian model (Opper & Archambeau 2009) behind a
    model's interface."""

    kern: object = None
    X: torch.Tensor = None
    Y: torch.Tensor = None
    likelihood: object = None

    @classmethod
    def create(cls, X, Y, kernel=None, likelihood=None, dtype=None, device=None):
        """A Gaussian likelihood of variance 1 unless given; ``device`` None
        means the card."""
        from .likelihoods import GaussianLik

        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        X = torch.as_tensor(np.atleast_2d(np.asarray(X, dtype=float)), **new)
        return cls(kern=kernel or RBF.create(X.shape[1], **new), X=X,
                   Y=torch.as_tensor(np.asarray(Y, dtype=float).reshape(-1), **new),
                   likelihood=likelihood or GaussianLik.create(1.0, **new))

    def inference(self, maxiter=200):
        from .var_gauss import vargauss_inference

        return vargauss_inference(self.kern.K(self.X), self.Y, self.likelihood, maxiter=maxiter)

    def log_marginal_likelihood(self):
        return self.inference().elbo

    def predict_latent(self, Xnew, posterior=None):
        from .var_gauss import vargauss_predict

        post = posterior if posterior is not None else self.inference()
        Xnew = torch.atleast_2d(torch.as_tensor(Xnew, dtype=self.X.dtype, device=self.X.device))
        return vargauss_predict(self.kern.K(self.X), self.kern.K(self.X, Xnew),
                                self.kern.Kdiag(Xnew), post)


class _OneVsAll:
    """One binary classifier per class, labels +1 for the class, -1 else."""

    def _build(self, model_cls, X, Y, kernel, kw):
        Y = np.asarray(Y).reshape(-1)
        self.classes_ = np.unique(Y)
        self.models = {}
        for c in self.classes_:
            k = kernel or RBF.create(np.atleast_2d(X).shape[1], dtype=kw.get("dtype"),
                                     device=kw.get("device"))
            self.models[c] = model_cls.create(X, np.where(Y == c, 1.0, -1.0), kernel=k, **kw)

    def predict_proba(self, Xnew):
        """(n, classes) one-vs-all probabilities, normalized per row."""
        ps = np.column_stack([self.models[c].predict(Xnew).detach().cpu().numpy().reshape(-1)
                              for c in self.classes_])
        return ps / ps.sum(axis=1, keepdims=True)

    def predict(self, Xnew):
        return self.classes_[np.argmax(self.predict_proba(Xnew), axis=1)]


class OneVsAllClassification(_OneVsAll):
    """One probit EP classifier per class."""

    def __init__(self, X, Y, kernel=None, **kw):
        self._build(GPClassification, X, Y, kernel, kw)


class OneVsAllSparseClassification(_OneVsAll):
    """One EPDTC classifier per class."""

    def __init__(self, X, Y, kernel=None, num_inducing=10, **kw):
        self._build(SparseGPClassification, X, Y, kernel, dict(kw, num_inducing=num_inducing))


@dataclasses.dataclass(frozen=True)
class _BackConstrained:
    """The fitted leaves of a back-constrained GPLVM, in the reference's order
    (its dict carrier, flattened by sorted key: the GP, then the mapping)."""

    gp: GPRegression = None
    map: object = None


def _latents(c: _BackConstrained, Y):
    return dataclasses.replace(c.gp, X=c.map.f(Y))


def fit_bcgplvm(Y, input_dim, mapping=None, kernel=None, noise_var=0.1, maxiter=300,
                hidden_dim=5, seed=0, dtype=None, device=None):
    """The back-constrained GPLVM: X = g(Y), the mapping ``g`` (a one-hidden-
    layer MLP by default, or ``models/mean_functions.KernelMapping``) trained
    with the kernel and the noise through the LML of the GP on X (Lawrence &
    Quinonero-Candela 2006). ``(gp, mapping, LBFGSResult)``."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    new = dict(dtype=dtype, device=device)
    Y = np.asarray(Y, dtype=float)
    Yc = Y - Y.mean(0)
    mapping = mapping or MLPMapping.create(Y.shape[1], input_dim, hidden_dim=hidden_dim,
                                           seed=seed, **new)
    base = GPRegression.create(np.zeros((Y.shape[0], input_dim)), Yc,
                               kernel=kernel or RBF.create(input_dim, ARD=True, **new),
                               noise_var=noise_var, **new)
    carrier = _BackConstrained(gp=base, map=mapping)
    packer = make_packer(carrier)  # gp.X is recomputed, a data leaf
    Yt = torch.as_tensor(Yc, **new)
    fitted, res = minimize_one(packer, carrier, maxiter, objective=lambda u: -_latents(
        packer.unpack(u, reference=carrier), Yt).log_marginal_likelihood())
    with torch.no_grad():
        return _latents(fitted, Yt), fitted.map, res


def fit_sparse_gplvm(Y, input_dim, num_inducing=10, kernel=None, noise_var=0.1, maxiter=300,
                     seed=0, dtype=None, device=None):
    """The point sparse GPLVM: the VarDTC bound over the hyperparameters, Z and
    the latent X from PCA. ``(fitted SparseGPRegression, LBFGSResult)``."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype, device)
    Y = np.asarray(Y, dtype=float)
    model = SparseGPRegression.create(
        pca_init(Y, input_dim), Y - Y.mean(0),
        kernel=kernel or RBF.create(input_dim, ARD=True, dtype=dtype, device=device),
        num_inducing=num_inducing, noise_var=noise_var, seed=seed, dtype=dtype, device=device)
    return minimize_one(gplvm_packer(model), model, maxiter)


@dataclasses.dataclass(frozen=True)
class GPOffsetRegression:
    """A trainable input offset per cluster (offset[0] = 0): the last input
    column names the cluster; the offsets train through the LML."""

    kern: object = None
    likelihood_variance: torch.Tensor = None
    offset: torch.Tensor = None  # (clusters - 1,)
    X: torch.Tensor = None       # (N, D), the inputs without the cluster column
    sel: torch.Tensor = None     # (N,) integer cluster index
    Y: torch.Tensor = None

    @classmethod
    def create(cls, X, Y, kernel=None, noise_var=1.0, dtype=None, device=None):
        """``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if X.shape[1] < 2:
            raise ValueError("the last input column must be the cluster index")
        sel = X[:, -1].astype(np.int64)
        Y = np.asarray(Y, dtype=float)
        Y = Y[:, None] if Y.ndim == 1 else Y
        return cls(kern=kernel or RBF.create(X.shape[1] - 1, **new),
                   likelihood_variance=torch.tensor(float(noise_var), **new),
                   offset=torch.zeros(int(sel.max()), **new),
                   X=torch.as_tensor(X[:, :-1], **new), sel=torch.as_tensor(sel, device=device),
                   Y=torch.as_tensor(Y, **new))

    def _offsets(self):
        return torch.cat([self.offset.new_zeros(1), self.offset])

    def _gp(self):
        return GPRegression(kern=self.kern, likelihood_variance=self.likelihood_variance,
                            X=self.X + self._offsets()[self.sel][:, None], Y=self.Y)

    def log_marginal_likelihood(self):
        return self._gp().log_marginal_likelihood()

    def predict(self, Xnew, cluster=0):
        Xnew = torch.atleast_2d(torch.as_tensor(Xnew, dtype=self.X.dtype, device=self.X.device))
        return self._gp().predict(Xnew + self._offsets()[cluster])

    def optimize(self, maxiter=100):
        return minimize_one(make_packer(self, fix=("sel",)), self, maxiter)

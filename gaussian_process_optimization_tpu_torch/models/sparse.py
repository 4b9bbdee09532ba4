"""Sparse (inducing-point) GP regression, the O(N M^2) path (twin of
``gaussian_process_optimization_tpu/models/sparse.py``; GPy
inference/latent_function_inference/var_dtc.py:14, fitc.py:21, dtc.py:23,
pep.py, models/sparse_gp_regression.py, core/sparse_gp.py:14).

Four collapsed bounds on one Lm / LB factorization: VarDTC (Titsias), DTC,
FITC and power EP, and the prediction they share. The inducing inputs ``Z`` are
a trainable leaf. Kmm and Kmn come from the kernel's own ``K``, so a stationary
kernel's pass the CUDA kernels' gate (float32, n m >= 128^2) and reach the K
build and its fused backward, the gradient with respect to Z included. The
bound takes the lane axis: with lane-batched parameters (``Packer.unpack`` of
``(B, n)``, the Fitter's restarts) ``Z`` is ``(B, M, D)`` and the bound ``(B,)``.
Padded rows (``mask``) contribute nothing, as in the exact GP.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.normalizer import Standardize
from .gp import LOG_2_PI

INFERENCES = ("vardtc", "fitc", "dtc", "pep")


@dataclasses.dataclass(frozen=True)
class SparsePosterior:
    Lm: torch.Tensor = None   # chol(Kmm)
    LB: torch.Tensor = None   # chol(I + A A^T / sigma2)
    c: torch.Tensor = None    # LB^-1 A y / sigma2
    lml: torch.Tensor = None
    ok: torch.Tensor = None


def kmm_init(X, m=10, rng=None):
    """k-means++-style inducing inputs (GPy util/misc.py:96 ``kmm_init``): a
    random first point, then each next one with probability proportional to
    its squared distance from the last one chosen (the reference's weighting,
    not the minimum over all chosen). ``rng`` is a numpy Generator."""
    rng = np.random.default_rng() if rng is None else rng
    X = np.atleast_2d(np.asarray(X, dtype=float))
    XXT = X @ X.T
    D = -2.0 * XXT + np.diag(XXT)[:, None] + np.diag(XXT)[None, :]
    s = int(rng.permutation(X.shape[0])[0])
    chosen = [s]
    prob = D[s] / D[s].sum()
    for _ in range(m - 1):
        s = int(rng.multinomial(1, prob.ravel()).argmax())
        chosen.append(s)
        prob = D[s] / D[s].sum()
    return X[np.asarray(chosen)]


def _eye(m, like):
    return torch.eye(m, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class SparseGPRegression:
    """``inference``: 'vardtc', 'fitc', 'dtc' or 'pep'; ``pep_alpha`` power EP's
    interpolation (1 is FITC, towards 0 VarDTC)."""

    kern: Kernel = None
    likelihood_variance: torch.Tensor = None
    Z: torch.Tensor = None
    X: torch.Tensor = None
    Y: torch.Tensor = None
    mask: torch.Tensor = None
    normalizer: Standardize = None
    inference: str = "vardtc"
    pep_alpha: float = 0.5

    @classmethod
    def create(cls, X, Y, kernel=None, num_inducing=10, Z=None, noise_var=1.0,
               normalizer=False, inference="vardtc", max_points=None, seed=0, dtype=None,
               device=None) -> "SparseGPRegression":
        """GPy's defaults (sparse_gp_regression.py): Z a random subset of X
        (numpy, seeded) unless given; ``max_points`` pads X and Y with a mask.
        ``device`` None means the card."""
        if inference not in INFERENCES:
            raise ValueError(f"unknown sparse inference {inference!r}; one of {INFERENCES}")
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        Xn = np.atleast_2d(np.asarray(X, dtype=float))
        Yn = np.asarray(Y, dtype=float)
        Yn = Yn[:, None] if Yn.ndim == 1 else Yn
        n, d = Xn.shape
        if kernel is None:
            kernel = RBF.create(d, **new)
        if Z is None:
            idx = np.random.default_rng(seed).permutation(n)[:num_inducing]
            Z = torch.as_tensor(Xn[idx].copy(), **new)
        elif isinstance(Z, torch.Tensor):
            Z = Z.detach().to(**new)
        else:
            Z = torch.as_tensor(np.atleast_2d(np.asarray(Z, dtype=float)), **new)
        Xt, Yt = torch.as_tensor(Xn, **new), torch.as_tensor(Yn, **new)
        norm = Standardize.fit(Yt) if normalizer else None
        mask = None
        if max_points is not None:
            if max_points < n:
                raise ValueError(f"max_points={max_points} < n={n}")
            Xt = torch.cat([Xt, Xt.new_zeros(max_points - n, d)])
            Yt = torch.cat([Yt, Yt.new_zeros(max_points - n, Yt.shape[1])])
            mask = (torch.arange(max_points, device=device) < n).to(dtype)
        noise = (noise_var.detach().to(**new) if isinstance(noise_var, torch.Tensor)
                 else torch.as_tensor(float(noise_var), **new)).reshape(())
        return cls(kern=kernel, likelihood_variance=noise, Z=Z, X=Xt, Y=Yt, mask=mask,
                   normalizer=norm, inference=inference)

    @property
    def num_data(self):
        return self.X.shape[0] if self.mask is None else torch.sum(self.mask)

    def _normalized_Y(self):
        Yn = self.normalizer.normalize(self.Y) if self.normalizer is not None else self.Y
        return Yn if self.mask is None else Yn * self.mask[:, None]

    def _factorize(self):
        """(Lm, A = Lm^-1 Kmn (lanes, M, N), Kdiag (lanes, N), Yc, ok), the
        padded columns of A zero."""
        Yc = self._normalized_Y()
        Kmm = self.kern.K(self.Z)
        m = self.Z.shape[-2]
        jitter = 1e-6 * torch.mean(torch.diagonal(Kmm, dim1=-2, dim2=-1), dim=-1)
        Kmm = Kmm + jitter[..., None, None] * _eye(m, Kmm)
        Lm, _, ok = linalg.jitchol(Kmm)
        Kmn = self.kern.K(self.Z, self.X)
        Kdiag = self.kern.Kdiag(self.X)
        if self.mask is not None:
            Kmn = Kmn * self.mask
            Kdiag = Kdiag * self.mask
        return Lm, linalg.solve_lower(Lm, Kmn), Kdiag, Yc, ok

    def inference_state(self) -> SparsePosterior:
        """The bound and the posterior's factors (var_dtc.py:66, fitc.py, dtc.py,
        pep.py); the bound has the lanes' shape."""
        sigma2 = self.likelihood_variance + config.noise_jitter
        s2 = sigma2[..., None, None]
        Lm, A, Kdiag, Yc, ok = self._factorize()
        n, m, p = self.num_data, A.shape[-2], Yc.shape[-1]

        if self.inference in ("fitc", "pep"):
            # FITC: per-row noise 1 / (sigma2 + Kdiag - Qnn). PEP (Bui et al.
            # 2017) scales the correction by alpha and adds an entropy penalty.
            g = torch.clamp(Kdiag - torch.sum(torch.square(A), dim=-2), min=0.0)
            alpha = 1.0 if self.inference == "fitc" else float(self.pep_alpha)
            lam = sigma2[..., None] + alpha * g
            if self.mask is not None:
                lam = torch.where(self.mask > 0, lam, torch.ones_like(lam))
            beta = 1.0 / lam
            Ab = A * beta[..., None, :]
            LB, _, okB = linalg.jitchol(_eye(m, A) + Ab @ A.mT)
            c = linalg.solve_lower(LB, Ab @ Yc)
            mask = self.mask if self.mask is not None else torch.ones_like(beta)
            lml = (-0.5 * n * p * LOG_2_PI
                   - 0.5 * p * torch.sum(torch.log(lam) * mask, dim=-1)
                   - 0.5 * p * linalg.logdet_from_chol(LB)
                   - 0.5 * torch.sum(torch.square(Yc) * beta[..., :, None], dim=(-2, -1))
                   + 0.5 * torch.sum(torch.square(c), dim=(-2, -1)))
            if self.inference == "pep":
                lml = lml - 0.5 * (1.0 - alpha) / alpha * p * torch.sum(
                    torch.log1p(alpha * g / sigma2[..., None]) * mask, dim=-1)
            return SparsePosterior(Lm=Lm, LB=LB, c=c, lml=lml, ok=ok & okB)

        # VarDTC and DTC share the homoscedastic factorization
        LB, _, okB = linalg.jitchol(_eye(m, A) + (A @ A.mT) / s2)
        c = linalg.solve_lower(LB, A @ Yc) / s2
        lml = (-0.5 * n * p * (LOG_2_PI + torch.log(sigma2))
               - 0.5 * p * linalg.logdet_from_chol(LB)
               - 0.5 * torch.sum(torch.square(Yc)) / sigma2
               + 0.5 * torch.sum(torch.square(c), dim=(-2, -1)))
        if self.inference == "vardtc":
            # Titsias's trace term (var_dtc.py:66): -(tr Knn - tr Qnn) / (2 sigma2),
            # differenced per point before the sum: in float32 the two traces are
            # each ~N variance and nearly cancel
            trace = torch.sum(Kdiag - torch.sum(torch.square(A), dim=-2), dim=-1)
            lml = lml - 0.5 * p * trace / sigma2
        return SparsePosterior(Lm=Lm, LB=LB, c=c, lml=lml, ok=ok & okB)

    def log_marginal_likelihood(self):
        return self.inference_state().lml

    # ------------------------------------------------------------- prediction
    def _raw_predict(self, Xnew, full_cov=False, posterior: SparsePosterior | None = None):
        post = posterior if posterior is not None else self.inference_state()
        tmp = linalg.solve_lower(post.Lm, self.kern.K(self.Z, Xnew))  # Lm^-1 Kms
        tmp2 = linalg.solve_lower(post.LB, tmp)
        mu = tmp2.mT @ post.c
        if full_cov:
            return mu, linalg.symmetrify(self.kern.K(Xnew) - tmp.mT @ tmp + tmp2.mT @ tmp2)
        var = (self.kern.Kdiag(Xnew) - torch.sum(torch.square(tmp), dim=-2)
               + torch.sum(torch.square(tmp2), dim=-2))
        return mu, torch.clamp(var, min=1e-15)[..., None]

    def predict(self, Xnew, full_cov=False, include_likelihood=True,
                posterior: SparsePosterior | None = None):
        mu, var = self._raw_predict(Xnew, full_cov=full_cov, posterior=posterior)
        if include_likelihood:
            var = var + (self.likelihood_variance * _eye(var.shape[-1], var) if full_cov
                         else self.likelihood_variance)
        if self.normalizer is not None:
            mu = self.normalizer.inverse_mean(mu)
            var = (self.normalizer.inverse_covariance(var) if full_cov
                   else self.normalizer.inverse_variance(var))
        return mu, var

    def predict_mean(self, Xnew, posterior: SparsePosterior):
        """The predictive mean alone, in original Y units."""
        tmp = linalg.solve_lower(posterior.Lm, self.kern.K(self.Z, Xnew))
        mu = linalg.solve_lower(posterior.LB, tmp).mT @ posterior.c
        return self.normalizer.inverse_mean(mu) if self.normalizer is not None else mu

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5),
                          posterior: SparsePosterior | None = None):
        """Gaussian predictive quantiles in percent (GPy gp.py:384), a list of
        ``(M, P)`` tensors."""
        mu, var = self.predict(Xnew, posterior=posterior)
        sd = torch.sqrt(var)
        return [mu + math.sqrt(2.0) * float(torch.special.erfinv(
            torch.tensor(2.0 * q / 100.0 - 1.0, dtype=torch.float64))) * sd
            for q in quantiles]

    def predictive_gradients(self, Xnew, posterior: SparsePosterior | None = None):
        """(dmu/dXnew (M, D, P), dvar/dXnew (M, D)) of the latent prediction in
        Y units; each row enters only its own prediction, so one backward of a
        sum gives every row's gradient."""
        post = posterior if posterior is not None else self.inference_state()
        with torch.enable_grad():
            X = Xnew.detach().requires_grad_(True)
            mu, var = self._raw_predict(X, posterior=post)
            if self.normalizer is not None:
                mu = self.normalizer.inverse_mean(mu)
                var = self.normalizer.inverse_variance(var)
            dmu = torch.stack([torch.autograd.grad(mu[:, p].sum(), X, retain_graph=True)[0]
                               for p in range(mu.shape[-1])], dim=-1)
            (dvar,) = torch.autograd.grad(var.sum(), X)
        return dmu, dvar

    def missing_data_lml(self, output_mask):
        """Missing-data VarDTC (GPy vardtc_md.py): output p sees only the rows
        with ``output_mask[:, p] == 1``; the sum of the per-output collapsed
        bounds on one Kmm factorization."""
        sigma2 = self.likelihood_variance + config.noise_jitter
        Lm, A, Kdiag, Yc, _ = self._factorize()
        m = A.shape[-2]
        mask_o = torch.as_tensor(np.asarray(output_mask), dtype=A.dtype, device=A.device)
        if self.mask is not None:
            mask_o = mask_o * self.mask[:, None]
        total = 0.0
        for y_col, w in zip(Yc.mT, mask_o.mT):
            Aw = A * w
            LB, _, _ = linalg.jitchol(_eye(m, A) + (Aw @ Aw.mT) / sigma2)
            c = linalg.solve_lower(LB, Aw @ (y_col * w)[:, None]) / sigma2
            trace = torch.sum(Kdiag * w) - torch.sum(torch.square(Aw))
            total = total + (-0.5 * torch.sum(w) * (LOG_2_PI + torch.log(sigma2))
                             - 0.5 * linalg.logdet_from_chol(LB)
                             - 0.5 * torch.sum(torch.square(y_col * w)) / sigma2
                             + 0.5 * torch.sum(torch.square(c))
                             - 0.5 * trace / sigma2)
        return total

    def with_data(self, X, Y, max_points=None) -> "SparseGPRegression":
        """The same model (kernel, Z, noise, inference, ``pep_alpha``) on new
        data."""
        new = SparseGPRegression.create(
            X, Y, kernel=self.kern, Z=self.Z, noise_var=self.likelihood_variance,
            normalizer=self.normalizer is not None, inference=self.inference,
            max_points=max_points, dtype=self.X.dtype, device=self.X.device)
        return dataclasses.replace(new, pep_alpha=self.pep_alpha)

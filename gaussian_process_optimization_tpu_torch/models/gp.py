"""Exact GP regression (twin of ``gaussian_process_optimization_tpu/models/gp.py``).

GPy's exact inference (exact_gaussian_inference.py:37):
  Ky = K + (sigma^2 + 1e-8) I;  L = jitchol(Ky);  logL = 0.5(-N log 2pi - logdet - Yc^T Ky^-1 Yc)
and PosteriorExact prediction (posterior.py:274).

The model is a frozen dataclass of tensors. When its hyperparameters carry a
lane axis (``Packer.unpack`` of a ``(B, n)`` batch), ``log_marginal_likelihood``
returns ``(B,)``: one value per optimizer restart. Two pieces have hand-written
backward passes, as in the reference:

- :class:`AssembleKy` — Ky = masked_gram(K + diag(noise)); its backward needs
  only the (N,) mask, so no (B, N, N) product operand is kept for it.
- :class:`ExactCore` — the jitter-ladder Cholesky and the half solve
  t = L^-1 Yc, with the closed-form pullback dKy = c_logdet Ky^-1 -
  c_quad alpha alpha^T (GPy's dL_dK). The ladder is never differentiated.

The ladder starts at the model's ``jitter_hint`` and, with ``jitter_greedy``,
keeps the first rung that factors (the BO wrappers' fit-trial policy,
``models/bo_models.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import config, resolve_device
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.normalizer import Standardize

LOG_2_PI = math.log(2.0 * math.pi)


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a broadcast gradient back to ``shape`` (leading lane axes)."""
    while g.ndim > len(shape):
        g = g.sum(dim=0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(dim=i, keepdim=True)
    return g


class AssembleKy(torch.autograd.Function):
    """Ky = masked_gram(K + diag(noise), mask) as one differentiable unit
    (the reference's ``_assemble_ky`` custom VJP, gp.py:116-156).
    noise: one homoscedastic variance per lane (shape ``lanes``)."""

    @staticmethod
    def forward(ctx, K, noise, mask):
        batch = torch.broadcast_shapes(K.shape[:-2], noise.shape)
        Ky = K.expand(batch + K.shape[-2:]).clone()
        Ky.diagonal(dim1=-2, dim2=-1).add_(noise.to(K.dtype)[..., None])
        if mask is not None:
            m = mask.to(K.dtype)
            Ky.mul_(m[:, None] * m[None, :])
            Ky.diagonal(dim1=-2, dim2=-1).add_(1.0 - m)
        ctx.save_for_backward(mask)
        ctx.k_shape, ctx.noise_shape = K.shape, noise.shape
        return Ky

    @staticmethod
    def backward(ctx, dKy):
        (mask,) = ctx.saved_tensors
        dK = dnoise = None
        m = None if mask is None else mask.to(dKy.dtype)
        if ctx.needs_input_grad[0]:
            dK = dKy if m is None else dKy * (m[:, None] * m[None, :])
            dK = _sum_to(dK, ctx.k_shape)
        if ctx.needs_input_grad[1]:
            diag = torch.diagonal(dKy, dim1=-2, dim2=-1)
            dnoise = _sum_to((diag if m is None else diag * m).sum(-1), ctx.noise_shape)
        return dK, dnoise, None


class ExactCore(torch.autograd.Function):
    """(logdet, quad, L, t, jitter, ok, rung) for the exact-GP LML, with the
    closed-form pullback of the reference's ``_exact_core`` (gp.py:44-113).

    Only logdet and quad are differentiable. alpha = L^-T t is not formed on
    the forward (the LML does not need it): :meth:`GPRegression.inference`
    forms it for the posterior, and the backward forms it as the matmul Li^T t
    from the Li it needs anyway."""

    @staticmethod
    def forward(ctx, Ky, Yc, hint, greedy):
        L, jitter, ok, rung = linalg.jitchol_full(Ky, k_start=hint, greedy=greedy)
        t = linalg.blocked_solve_lower(L, Yc)
        logdet = linalg.logdet_from_chol(L)
        quad = torch.sum(t * t, dim=(-2, -1))
        ctx.save_for_backward(L, t)
        ctx.yc_shape = Yc.shape
        ctx.mark_non_differentiable(L, t, jitter, ok, rung)
        return logdet, quad, L, t, jitter, ok, rung

    @staticmethod
    def backward(ctx, c_logdet, c_quad, *_):
        L, t = ctx.saved_tensors
        Li = linalg.tri_inv_lower(L)
        alpha = Li.transpose(-1, -2) @ t
        dKy = dYc = None
        if ctx.needs_input_grad[0]:
            Wi = linalg.tri_tdot(Li)
            del Li
            dKy = Wi.mul_(c_logdet[..., None, None])
            dKy.sub_((alpha @ alpha.transpose(-1, -2)).mul_(c_quad[..., None, None]))
        if ctx.needs_input_grad[1]:
            dYc = _sum_to((2.0 * c_quad[..., None, None]) * alpha, ctx.yc_shape)
        return dKy, dYc, None, None


@dataclasses.dataclass(frozen=True)
class Posterior:
    """Woodbury representation of the exact posterior (GPy posterior.py:9).
    ``Li`` (optional, = L^-1) makes prediction matmul-only."""

    L: torch.Tensor = None
    alpha: torch.Tensor = None
    jitter: torch.Tensor = None
    ok: torch.Tensor = None
    lml: torch.Tensor = None
    Li: torch.Tensor = None
    rung: torch.Tensor = None


@dataclasses.dataclass(frozen=True)
class GPRegression:
    """Exact GP regression with a Gaussian likelihood. ``X (N, D)`` and
    ``Y (N, P)`` may be padded to a fixed budget; ``mask (N,)`` flags real rows.
    ``jitter_hint`` (a scalar, None = 0) is the first ladder rung probed, a data
    leaf; ``jitter_greedy`` keeps the first rung that factors instead of
    verifying the minimal one (``ops/linalg.jitchol_full``)."""

    kern: Kernel = None
    likelihood_variance: torch.Tensor = None
    X: torch.Tensor = None
    Y: torch.Tensor = None
    mask: torch.Tensor = None
    normalizer: Standardize = None
    jitter_hint: torch.Tensor = None
    jitter_greedy: bool = False

    @classmethod
    def create(cls, X, Y, kernel: Kernel | None = None, noise_var: float = 1.0,
               normalizer: bool = False, max_points: int | None = None,
               dtype=torch.float64, device=None) -> "GPRegression":
        """GPy-style constructor (gp.py:215-268): optional padding to
        ``max_points`` rows with a mask (always present when padding is asked
        for). Homoscedastic noise only. ``device`` None means the card."""
        device = resolve_device(device)
        X = torch.as_tensor(np.asarray(X), dtype=dtype, device=device)
        X = X.reshape(1, -1) if X.ndim == 1 else X
        Y = torch.as_tensor(np.asarray(Y), dtype=dtype, device=device)
        Y = Y[:, None] if Y.ndim == 1 else Y
        n, d = X.shape
        if kernel is None:
            kernel = RBF.create(d, dtype=dtype, device=device)
        norm = Standardize.fit(Y) if normalizer else None
        mask = None
        if max_points is not None:
            if max_points < n:
                raise ValueError(f"max_points={max_points} < n={n}")
            pad = max_points - n
            X = torch.cat([X, X.new_zeros(pad, d)])
            Y = torch.cat([Y, Y.new_zeros(pad, Y.shape[1])])
            mask = (torch.arange(max_points, device=X.device) < n).to(dtype)
        noise = torch.as_tensor(noise_var, dtype=dtype, device=device)
        if noise.numel() != 1:
            raise ValueError("heteroscedastic noise is not ported; pass a scalar noise_var")
        return cls(kern=kernel, likelihood_variance=noise.reshape(()), X=X, Y=Y,
                   mask=mask, normalizer=norm)

    def with_data(self, X, Y, max_points: int | None = None) -> "GPRegression":
        """The same model on new data (GPy ``set_XY``, gp.py:270-301): the
        normalizer is refitted, and the ladder's hint and policy carry over."""
        new = GPRegression.create(
            X, Y, kernel=self.kern, noise_var=self.likelihood_variance,
            normalizer=self.normalizer is not None, max_points=max_points,
            dtype=self.X.dtype, device=self.X.device)
        return dataclasses.replace(new, jitter_hint=self.jitter_hint,
                                   jitter_greedy=self.jitter_greedy)

    @property
    def num_data(self):
        if self.mask is None:
            return self.X.shape[0]
        return torch.sum(self.mask)

    def _normalized_Y(self):
        Yn = self.normalizer.normalize(self.Y) if self.normalizer is not None else self.Y
        if self.mask is not None:
            Yn = Yn * self.mask[:, None]
        return Yn

    def _effective_noise(self, dtype):
        """sigma^2 + 1e-8, floored in float32 only (``config.f32_noise_floor``):
        f32 Cholesky cannot resolve a smaller noise once the kernel variance
        grows, and the kernels run in f32 on the card."""
        noise = self.likelihood_variance + config.noise_jitter
        if dtype == torch.float32:
            noise = torch.clamp(noise, min=config.f32_noise_floor)
        return noise

    def _core(self):
        Yc = self._normalized_Y()
        K = self.kern.K(self.X)
        Ky = AssembleKy.apply(K, self._effective_noise(K.dtype), self.mask)
        del K
        logdet, quad, L, t, jitter, ok, rung = ExactCore.apply(
            Ky, Yc, self.jitter_hint, self.jitter_greedy)
        p = Yc.shape[-1]
        lml = 0.5 * (-self.num_data * p * LOG_2_PI - p * logdet - quad)
        return lml, L, t, jitter, ok, rung

    def log_marginal_likelihood(self) -> torch.Tensor:
        return self._core()[0]

    def inference(self, precompute_inverse: bool = False) -> Posterior:
        """Exact Gaussian inference (exact_gaussian_inference.py:37-75);
        ``precompute_inverse`` also stores Li = L^-1 for matmul-only predictions."""
        lml, L, t, jitter, ok, rung = self._core()
        alpha = linalg.solve_lower_t(L, t)
        Li = linalg.tri_inv_lower(L) if precompute_inverse else None
        return Posterior(L=L, alpha=alpha, jitter=jitter, ok=ok, lml=lml, Li=Li, rung=rung)

    def _cross(self, Xnew):
        Kx = self.kern.K(self.X, Xnew)
        if self.mask is not None:
            Kx = Kx * self.mask[:, None]
        return Kx

    def _raw_predict(self, Xnew, posterior: Posterior | None = None):
        """Latent mean and variance in normalized space (PosteriorExact._raw_predict).
        ``Xnew`` is ``(M, D)`` or lane-batched ``(B, M, D)``."""
        post = posterior if posterior is not None else self.inference()
        Kx = self._cross(Xnew)
        mu = Kx.transpose(-1, -2) @ post.alpha
        tmp = post.Li @ Kx if post.Li is not None else linalg.solve_lower(post.L, Kx)
        var = self.kern.Kdiag(Xnew) - torch.sum(torch.square(tmp), dim=-2)
        return mu, torch.clamp(var, min=1e-15)[..., None]

    def predict(self, Xnew, posterior: Posterior | None = None):
        """Mean and variance, likelihood noise included, in original Y units
        (GPy gp.py:297)."""
        mu, var = self._raw_predict(Xnew, posterior=posterior)
        var = var + self.likelihood_variance
        if self.normalizer is not None:
            mu = self.normalizer.inverse_mean(mu)
            var = self.normalizer.inverse_variance(var)
        return mu, var

    def predict_mean(self, Xnew, posterior: Posterior):
        """The predictive mean alone, in original Y units (``predict``'s first
        output without the variance's O(N^2 M) work)."""
        mu = self._cross(Xnew).transpose(-1, -2) @ posterior.alpha
        return self.normalizer.inverse_mean(mu) if self.normalizer is not None else mu

    def predictive_gradients(self, Xnew, posterior: Posterior | None = None):
        """(dmu/dXnew (M, D, P), dvar/dXnew (M, D)) of the latent prediction in Y
        units (GPy gp.py:407). Each row of ``Xnew`` enters only its own
        prediction, so one backward of a sum gives every row's gradient."""
        post = posterior if posterior is not None else self.inference()
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

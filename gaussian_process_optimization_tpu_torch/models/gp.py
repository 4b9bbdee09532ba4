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

from ..config import config, resolve_device, resolve_dtype
from ..kernels.base import Kernel
from ..kernels.stationary import RBF
from ..ops import linalg
from ..utils.normalizer import Standardize
from ..utils.profiling import spanned
from .mean_functions import Mapping

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
    noise: one homoscedastic variance per lane (shape ``lanes``), or with
    ``per_point`` one variance per lane and row (shape ``lanes + (N,)``). The
    flag, not the shape, tells the two apart: 5 lanes of 5 rows are both."""

    @staticmethod
    def forward(ctx, K, noise, mask, per_point=False):
        if not per_point:
            noise = noise[..., None]
        batch = torch.broadcast_shapes(K.shape[:-2], noise.shape[:-1])
        Ky = K.expand(batch + K.shape[-2:]).clone()
        Ky.diagonal(dim1=-2, dim2=-1).add_(noise.to(K.dtype))
        if mask is not None:
            m = mask.to(K.dtype)
            Ky.mul_(m[:, None] * m[None, :])
            Ky.diagonal(dim1=-2, dim2=-1).add_(1.0 - m)
        ctx.save_for_backward(mask)
        ctx.k_shape, ctx.noise_shape, ctx.per_point = K.shape, noise.shape, per_point
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
            dnoise = _sum_to(diag if m is None else diag * m, ctx.noise_shape)
            if not ctx.per_point:
                dnoise = dnoise[..., 0]
        return dK, dnoise, None, None


class ExactCore(torch.autograd.Function):
    """(logdet, quad, L, t, jitter, ok, rung) for the exact-GP LML, with the
    closed-form pullback of the reference's ``_exact_core`` (gp.py:44-113).

    Only logdet and quad are differentiable. alpha = L^-T t is not formed on
    the forward (the LML does not need it): :meth:`GPRegression.inference`
    forms it for the posterior, and the backward forms it as the matmul Li^T t
    from the Li it needs anyway. The backward's products run at
    ``config.grad_matmul_precision``, as the reference's ``_exact_core_bwd``."""

    @staticmethod
    @spanned("gp.exact_fwd")
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
    @spanned("gp.exact_bwd")
    def backward(ctx, c_logdet, c_quad, *_):
        L, t = ctx.saved_tensors
        # the gradient-only precision (config.grad_matmul_precision): these
        # products steer the optimizer and never reach a prediction
        prec = config.grad_matmul_precision
        prec = None if prec == "highest" else prec
        Li = linalg.tri_inv_lower(L, precision=prec)
        alpha = linalg.matmul(Li.transpose(-1, -2), t, prec)
        dKy = dYc = None
        if ctx.needs_input_grad[0]:
            Wi = linalg.tri_tdot(Li, precision=prec)
            del Li
            dKy = Wi.mul_(c_logdet[..., None, None])
            dKy.sub_(linalg.matmul(alpha, alpha.transpose(-1, -2), prec)
                     .mul_(c_quad[..., None, None]))
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
    ``jitter_hint`` (a scalar, or one per lane; None = 0) is the first ladder
    rung probed, a data leaf (the thread ladder sets a ``(B,)`` hint, one per
    restart lane, on the unpacked model); ``jitter_greedy`` keeps the first
    rung that factors instead of verifying the minimal one
    (``ops/linalg.jitchol_full``).

    Noise and lanes: ``likelihood_variance`` has shape ``lanes`` (one variance
    per lane), or ``lanes + (N,)`` when ``heteroscedastic`` (one per lane and
    row, GPy's HeteroscedasticGaussian). The static flag decides, never the
    shape."""

    kern: Kernel = None
    likelihood_variance: torch.Tensor = None
    X: torch.Tensor = None
    Y: torch.Tensor = None
    mask: torch.Tensor = None
    mean_function: Mapping = None
    normalizer: Standardize = None
    jitter_hint: torch.Tensor = None
    jitter_greedy: bool = False
    heteroscedastic: bool = False

    @classmethod
    def create(cls, X, Y, kernel: Kernel | None = None, noise_var=1.0,
               normalizer: bool = False, mean_function: Mapping | None = None,
               max_points: int | None = None, dtype=None,
               device=None) -> "GPRegression":
        """GPy-style constructor (gp.py:215-268): optional padding to
        ``max_points`` rows with a mask (always present when padding is asked
        for). A scalar ``noise_var`` is homoscedastic; an ``(N,)`` vector gives
        each row its own noise. ``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
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
        if isinstance(noise_var, torch.Tensor):
            noise = noise_var.detach().to(dtype=dtype, device=device)
        else:
            noise = torch.as_tensor(np.asarray(noise_var, dtype=float), dtype=dtype,
                                    device=device)
        hetero = noise.ndim > 0 and noise.numel() != 1
        if hetero:
            noise = noise.reshape(-1)
            if noise.shape[0] != n:
                raise ValueError(f"heteroscedastic noise_var has {noise.shape[0]} entries "
                                 f"for {n} data points")
            if max_points is not None:
                # padded like X and Y; the value is never read: the padded rows
                # of Ky are replaced by identity rows
                noise = torch.cat([noise, noise.new_ones(max_points - n)])
        else:
            noise = noise.reshape(())
        return cls(kern=kernel, likelihood_variance=noise, X=X, Y=Y, mask=mask,
                   mean_function=mean_function, normalizer=norm, heteroscedastic=hetero)

    def with_data(self, X, Y, max_points: int | None = None) -> "GPRegression":
        """The same model on new data (GPy ``set_XY``, gp.py:270-301): the
        normalizer is refitted, and the ladder's hint and policy carry over. A
        per-row noise belongs to the old rows, so it carries over only to the
        same number of rows."""
        noise = self.likelihood_variance
        if self.heteroscedastic:
            n_new = np.atleast_2d(np.asarray(X)).shape[0]
            n_old = int(self.num_data)
            if n_new != n_old:
                raise ValueError(
                    "with_data on a heteroscedastic model with a different number of "
                    "rows: per-point noise for the new rows is unknown; rebuild with "
                    "GPRegression.create(..., noise_var=<per-point variances>)")
            noise = noise[:n_old]  # strip the padding; create() pads again
        new = GPRegression.create(
            X, Y, kernel=self.kern, noise_var=noise,
            normalizer=self.normalizer is not None, mean_function=self.mean_function,
            max_points=max_points, dtype=self.X.dtype, device=self.X.device)
        return dataclasses.replace(new, jitter_hint=self.jitter_hint,
                                   jitter_greedy=self.jitter_greedy)

    @property
    def num_data(self):
        if self.mask is None:
            return self.X.shape[0]
        return torch.sum(self.mask)

    def _normalized_Y(self):
        """Centred targets; under lanes in the mean function's leaves,
        ``lanes + (N, P)``. The graph from the mean function's parameters to
        the result is kept: their gradient flows through ``Yc``."""
        Yn = self.normalizer.normalize(self.Y) if self.normalizer is not None else self.Y
        if self.mean_function is not None:
            Yn = Yn - self.mean_function.f(self.X)
        if self.mask is not None:
            Yn = Yn * self.mask[:, None]
        return Yn

    def _effective_noise(self, dtype):
        """sigma^2 + 1e-8, floored in float32 only (``config.f32_noise_floor``):
        f32 Cholesky cannot resolve a smaller noise once the kernel variance
        grows, and the kernels run in f32 on the card. Shaped as
        ``likelihood_variance`` is."""
        noise = self.likelihood_variance + config.noise_jitter
        if dtype == torch.float32:
            noise = torch.clamp(noise, min=config.f32_noise_floor)
        return noise

    def _noise_at_test(self, noise_at_test=None):
        """Likelihood variance added at test points (gp.py:328). A scalar model
        gives its scalar (an explicit ``noise_at_test`` overrides it). A
        heteroscedastic model's training noises do not determine the noise at
        a test point, so the caller says what is meant: ``'mean'`` (mean over
        the real training rows), a scalar, or an ``(M,)`` array."""
        v = self.likelihood_variance
        if isinstance(noise_at_test, str) and noise_at_test != "mean":
            raise ValueError(f"unknown noise_at_test mode {noise_at_test!r}")
        if not self.heteroscedastic:
            if noise_at_test is None or isinstance(noise_at_test, str):
                return v
            return torch.as_tensor(noise_at_test, dtype=v.dtype, device=v.device)
        if noise_at_test is None:
            raise ValueError(
                "heteroscedastic model: test-point likelihood variance is ambiguous; "
                "pass noise_at_test='mean', a scalar, or a per-test-point (M,) array, "
                "or use predict_noiseless()")
        if isinstance(noise_at_test, str):
            if self.mask is not None:
                return torch.sum(v * self.mask, -1) / torch.clamp(torch.sum(self.mask), min=1.0)
            return torch.mean(v, -1)
        return torch.as_tensor(noise_at_test, dtype=v.dtype, device=v.device)

    def _core(self):
        Yc = self._normalized_Y()
        K = self.kern.K(self.X)
        Ky = AssembleKy.apply(K, self._effective_noise(K.dtype), self.mask,
                              self.heteroscedastic)
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

    def _half(self, post: Posterior, Kx):
        """L^-1 Kx, by matmul when the posterior carries Li."""
        return post.Li @ Kx if post.Li is not None else linalg.solve_lower(post.L, Kx)

    def _raw_predict(self, Xnew, full_cov: bool = False, posterior: Posterior | None = None):
        """Latent mean and variance in normalized space (PosteriorExact._raw_predict).
        ``Xnew`` is ``(M, D)`` or lane-batched ``(B, M, D)``; with ``full_cov``
        the ``(M, M)`` covariance instead of the ``(M, 1)`` variances."""
        post = posterior if posterior is not None else self.inference()
        Kx = self._cross(Xnew)
        mu = Kx.transpose(-1, -2) @ post.alpha
        if self.mean_function is not None:
            mu = mu + self.mean_function.f(Xnew)
        tmp = self._half(post, Kx)
        if full_cov:
            return mu, linalg.symmetrify(self.kern.K(Xnew) - tmp.transpose(-1, -2) @ tmp)
        var = self.kern.Kdiag(Xnew) - torch.sum(torch.square(tmp), dim=-2)
        return mu, torch.clamp(var, min=1e-15)[..., None]

    def predict(self, Xnew, full_cov: bool = False, include_likelihood: bool = True,
                posterior: Posterior | None = None, noise_at_test=None):
        """Mean and variance in original Y units, the likelihood's noise added
        unless ``include_likelihood`` is off (GPy gp.py:297). ``noise_at_test``
        chooses a heteroscedastic model's noise at the test points
        (:meth:`_noise_at_test`)."""
        mu, var = self._raw_predict(Xnew, full_cov=full_cov, posterior=posterior)
        if include_likelihood:
            noise = self._noise_at_test(noise_at_test)
            if full_cov:
                var = var + torch.diag(noise.to(var.dtype).expand(var.shape[-1]))
            elif noise.ndim == 1 and not (noise_at_test is None
                                          or isinstance(noise_at_test, str)):
                var = var + noise[:, None]           # one variance per test point
            else:
                var = var + (noise[..., None, None] if noise.ndim else noise)  # per lane
        if self.normalizer is not None:
            mu = self.normalizer.inverse_mean(mu)
            var = (self.normalizer.inverse_covariance(var) if full_cov
                   else self.normalizer.inverse_variance(var))
        return mu, var

    def predict_noiseless(self, Xnew, full_cov: bool = False,
                          posterior: Posterior | None = None):
        return self.predict(Xnew, full_cov=full_cov, include_likelihood=False,
                            posterior=posterior)

    def predict_mean(self, Xnew, posterior: Posterior):
        """The predictive mean alone, in original Y units (``predict``'s first
        output without the variance's O(N^2 M) work)."""
        mu = self._cross(Xnew).transpose(-1, -2) @ posterior.alpha
        if self.mean_function is not None:
            mu = mu + self.mean_function.f(Xnew)
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

    def posterior_samples_f(self, Xnew, size: int, generator: torch.Generator | None = None,
                            z: torch.Tensor | None = None,
                            posterior: Posterior | None = None):
        """``(M, size)`` samples of the latent function (GPy gp.py:585):
        mu + chol(cov + 1e-10 I) z. The standard normals ``z (M, size)`` are
        drawn from ``generator`` unless handed in."""
        mu, cov = self._raw_predict(Xnew, full_cov=True, posterior=posterior)
        m = Xnew.shape[0]
        cov = cov + 1e-10 * torch.eye(m, dtype=cov.dtype, device=cov.device)
        Lc, _, _ = linalg.jitchol(cov)
        if z is None:
            z = torch.randn((m, size), generator=generator, dtype=cov.dtype,
                            device=cov.device)
        samples = mu + Lc @ z
        if self.normalizer is not None:
            samples = self.normalizer.inverse_mean(samples)
        return samples

    def posterior_samples(self, Xnew, size: int, generator: torch.Generator | None = None,
                          noise_at_test=None, *, z: torch.Tensor | None = None,
                          posterior: Posterior | None = None):
        """``(M, size)`` samples of noisy observations (GPy gp.py:611). ``z`` is
        ``(2, M, size)``: the latent draws, then the noise draws."""
        if z is None:
            z = torch.randn((2, Xnew.shape[0], size), generator=generator,
                            dtype=self.X.dtype, device=self.X.device)
        f = self.posterior_samples_f(Xnew, size, z=z[0], posterior=posterior)
        noise = self._noise_at_test(noise_at_test)
        noise_std = torch.sqrt(noise[:, None] if noise.ndim == 1 else noise)  # no lanes here
        if self.normalizer is not None:
            noise_std = noise_std * self.normalizer.std.reshape(-1)[0]
        return f + noise_std * z[1]

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), noise_at_test=None,
                          posterior: Posterior | None = None):
        """Predictive quantiles in percent (GPy gp.py:384): mu + sd Phi^-1(q / 100),
        a list of ``(M, P)`` tensors."""
        mu, var = self.predict(Xnew, posterior=posterior, noise_at_test=noise_at_test)
        sd = torch.sqrt(var)
        return [mu + math.sqrt(2.0) * float(torch.special.erfinv(
            torch.tensor(2.0 * q / 100.0 - 1.0, dtype=torch.float64))) * sd
            for q in quantiles]

    def log_predictive_density(self, x_test, y_test, noise_at_test=None,
                               posterior: Posterior | None = None):
        """Per-point log p(y* | D) under the Gaussian predictive, in original Y
        units (GPy gp.py:680)."""
        y_test = torch.as_tensor(y_test, dtype=self.X.dtype, device=self.X.device)
        y_test = y_test.reshape(1, -1) if y_test.ndim < 2 else y_test
        mu, var = self.predict(x_test, posterior=posterior, noise_at_test=noise_at_test)
        return -0.5 * (LOG_2_PI + torch.log(var) + torch.square(y_test - mu) / var)

    def log_predictive_density_sampling(self, x_test, y_test,
                                        generator: torch.Generator | None = None,
                                        num_samples: int = 1000, noise_at_test=None, *,
                                        z: torch.Tensor | None = None,
                                        posterior: Posterior | None = None):
        """Monte Carlo log p(y* | D) = log mean_s p(y* | f_s), f_s ~ p(f* | D)
        (GPy gp.py:696), in original Y units. The standard normals ``z (M,
        num_samples)`` are drawn from ``generator`` unless handed in."""
        y_test = torch.as_tensor(y_test, dtype=self.X.dtype, device=self.X.device)
        y_test = y_test.reshape(1, -1) if y_test.ndim < 2 else y_test
        mu, var = self._raw_predict(x_test, posterior=posterior)
        if z is None:
            z = torch.randn((mu.shape[0], num_samples), generator=generator, dtype=mu.dtype,
                            device=mu.device)
        f = mu + torch.sqrt(var) * z
        noise = self._noise_at_test(noise_at_test)
        noise = noise[:, None] if noise.ndim == 1 else noise
        if self.normalizer is not None:
            f = self.normalizer.inverse_mean(f)
            noise = self.normalizer.inverse_variance(noise)
        lp = -0.5 * (LOG_2_PI + torch.log(noise) + torch.square(y_test - f) / noise)
        return torch.logsumexp(lp, dim=1, keepdim=True) - math.log(z.shape[1])

    def posterior_covariance_between_points(self, X1, X2,
                                            posterior: Posterior | None = None):
        """K(X1, X2) - K(X, X1)^T Ky^-1 K(X, X2) in normalized space (GPy gp.py:714)."""
        post = posterior if posterior is not None else self.inference()
        t1, t2 = self._half(post, self._cross(X1)), self._half(post, self._cross(X2))
        return self.kern.K(X1, X2) - t1.transpose(-1, -2) @ t2

    def predict_jacobian(self, Xnew, posterior: Posterior | None = None):
        """Mean and covariance of the derivative of the posterior GP (GPy
        gp.py:456): ``(mean_jac (M, D, P), var_jac (M, D, D))`` with
        Cov[df/dx] = d2k/dx dx' - (dKx/dx)^T Ky^-1 (dKx/dx'), in normalized
        space. The prior curvature is the kernel's ``d2K_dXdX2_diag``. Column m
        of K(X, Xnew) depends on row m of Xnew alone, so one forward-mode pass
        per input dimension gives dKx/dx for every test point."""
        post = posterior if posterior is not None else self.inference()
        M, D = Xnew.shape
        cols = []
        for d in range(D):
            tangent = torch.zeros_like(Xnew)
            tangent[:, d] = 1.0
            cols.append(torch.func.jvp(self._cross, (Xnew,), (tangent,))[1])
        dKx = torch.stack(cols, dim=-1)                       # (N, M, D)
        mean_jac = torch.einsum("nmd,np->mdp", dKx, post.alpha)
        J = self._half(post, dKx.reshape(dKx.shape[0], M * D)).reshape(-1, M, D)
        data = torch.einsum("nmd,nme->mde", J, J)
        prior = torch.stack([self.kern.d2K_dXdX2_diag(x) for x in Xnew])
        return mean_jac, prior - data

    def predict_wishart_embedding(self, Xnew, mean: bool = True, covariance: bool = True,
                                  posterior: Posterior | None = None):
        """The expected metric G = J_mu^T J_mu + P Cov[J] of the mapping
        (GPy gp.py:521), ``(M, D, D)``."""
        mean_jac, var_jac = self.predict_jacobian(Xnew, posterior=posterior)
        G = torch.zeros_like(var_jac)
        if mean:
            G = G + torch.einsum("idp,iep->ide", mean_jac, mean_jac)
        if covariance:
            G = G + self.Y.shape[1] * var_jac
        return G

    def predict_magnification(self, Xnew, mean: bool = True, covariance: bool = True,
                              dimensions=None, posterior: Posterior | None = None):
        """sqrt(det G) per test point over ``dimensions``, by default the two
        input dimensions of largest ARD sensitivity (GPy gp.py:556). The
        determinant is floored at 0: in float32 the prior and data terms of G
        cancel to a tiny negative one."""
        G = self.predict_wishart_embedding(Xnew, mean=mean, covariance=covariance,
                                           posterior=posterior)
        if dimensions is None:
            rel = self.kern.input_sensitivity().detach().cpu().numpy().reshape(-1)
            dimensions = tuple(np.argsort(rel)[::-1][:2].tolist())
        dims = torch.as_tensor(dimensions, device=G.device)
        Gs = G[:, dims][:, :, dims]
        return torch.sqrt(torch.clamp(torch.linalg.det(Gs), min=0.0))

    def log_likelihood_LOO(self):
        """Leave-one-out predictive log density per row
        (exact_gaussian_inference.py LOO:77)."""
        post = self.inference()
        Yc = self._normalized_Y()
        diag_Ki = torch.diagonal(linalg.dpotri(post.L))
        var_loo = 1.0 / diag_Ki
        mu_loo = Yc - post.alpha / diag_Ki[:, None]
        lpd = -0.5 * (LOG_2_PI + torch.log(var_loo)[:, None]
                      + torch.square(Yc - mu_loo) / var_loo[:, None])
        if self.mask is not None:
            lpd = lpd * self.mask[:, None]
        return lpd

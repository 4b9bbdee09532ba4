"""Exact GP and EI in plain float64 PyTorch.

Each function follows the published formulas (GPy's exact inference and
Matern52, the reference author's Gower kernel, GPyOpt's EI) and the stated
conventions of the configuration file: the float32 noise floor, the jitter
ladder's rung values and the padding bucket. Nothing here imports the system
under test.
"""
from __future__ import annotations

import math

import torch

SQRT5 = math.sqrt(5.0)
LOG_2_PI = math.log(2.0 * math.pi)


def matern52_of_r(r):
    """Unit-variance Matern52 profile (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r)."""
    return (1.0 + SQRT5 * r + 5.0 / 3.0 * r * r) * torch.exp(-SQRT5 * r)


class Kernel:
    """K(X1, X2) and kdiag for one configuration's covariance.

    ``spec`` is the configuration's ``kernel`` block; ``params`` maps the
    parameter names to float64 tensors (``variance``, ``lengthscale``)."""

    def __init__(self, spec: dict, params: dict):
        self.spec = spec
        self.params = params

    def K(self, X1, X2):
        kind = self.spec["family"]
        var = self.params["variance"]
        if kind == "matern52_ard":
            ls = self.params["lengthscale"]
            out = []
            for i in range(0, X1.shape[0], 2048):
                d = (X1[i:i + 2048, None, :] - X2[None, :, :]) / ls
                r2 = torch.sum(d * d, dim=-1)
                out.append(var * matern52_of_r(torch.sqrt(torch.clamp(r2, min=1e-300))))
            return torch.cat(out)
        if kind == "gower_matern52":
            # the reference author's Gower product: each of the D factors carries
            # the variance; continuous r_d = |dx| / range_d, discrete r_d = 1[dx != 0]
            out = None
            cont = self.spec["continuous_dims"]
            ranges = self.spec["ranges"]
            for d in range(X1.shape[1]):
                diff = X1[:, None, d] - X2[None, :, d]
                if d in cont:
                    r = torch.abs(diff) / ranges[cont.index(d)]
                else:
                    r = (diff != 0).to(X1.dtype)
                f = var * matern52_of_r(r)
                out = f if out is None else out * f
            return out
        raise ValueError(f"unknown kernel family {kind!r}")

    def Kdiag(self, X):
        # the Gower kernel's diagonal is the variance, not variance^D (the
        # reference author's convention, stated in the configuration)
        return self.params["variance"] * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


def normalize(Y):
    """GPyOpt's 'stats' normalization: (Y - mean) / population std."""
    s = Y.std(unbiased=False)
    return (Y - Y.mean()) / s if float(s) > 0 else Y - Y.mean()


def bucket(n: int, minimum: int = 16) -> int:
    """The padding bucket the configuration states: the next power of two."""
    return max(minimum, 2 ** math.ceil(math.log2(max(n, 1))))


def gram(K, noise: float, stated: dict, rung: int):
    """(Ky, jitter, padded rows): K plus max(noise + noise_jitter, noise_floor)
    and the ladder's jitter on the diagonal."""
    n = K.shape[0]
    eff = max(noise + stated["noise_jitter"], stated["noise_floor"])
    pad = bucket(n) - n
    with torch.no_grad():
        diag_mean = (torch.diagonal(K).sum() + n * eff + pad) / (n + pad)
    jitter = 0.0 if rung == 0 else float(diag_mean) * stated["jitter_base"] * 10.0 ** (rung - 1)
    Ky = K + (eff + jitter) * torch.eye(n, dtype=K.dtype, device=K.device)
    return Ky, jitter, pad


class Posterior:
    """Exact posterior at fixed hyperparameters.

    ``noise`` is the likelihood variance; the Gram diagonal carries
    max(noise + noise_jitter, noise_floor) plus the ladder's jitter at
    ``rung``: 0 at rung 0, else mean(diag Ky_padded) * base * 10^(rung - 1),
    where the padded Ky holds identity rows for the bucket's empty rows."""

    def __init__(self, kern: Kernel, X, Y, noise: float, stated: dict, rung: int):
        self.kern, self.X, self.noise = kern, X, noise
        n = X.shape[0]
        self.Yn = normalize(Y)
        K = kern.K(X, X)
        Ky, self.jitter, pad = gram(K, noise, stated, rung)
        del K
        self.L = torch.linalg.cholesky(Ky)
        del Ky
        self.alpha = torch.cholesky_solve(self.Yn, self.L)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(self.L))) + pad * math.log1p(self.jitter)
        quad = torch.sum(self.Yn * self.alpha)
        self.lml = float(0.5 * (-n * LOG_2_PI - logdet - quad))

    def mean(self, Xs):
        return self.kern.K(Xs, self.X) @ self.alpha

    def predict(self, Xs):
        """(mean, std) as GPyOpt's model gives them: the latent variance
        floored at 1e-15, the likelihood variance added, the std of the
        variance floored at 1e-10."""
        Kx = self.kern.K(self.X, Xs)
        mu = Kx.T @ self.alpha
        t = torch.linalg.solve_triangular(self.L, Kx, upper=False)
        var = torch.clamp(self.kern.Kdiag(Xs) - torch.sum(t * t, dim=0), min=1e-15)
        var = var + self.noise
        return mu[:, 0], torch.sqrt(torch.clamp(var, min=1e-10))

    def fmin(self):
        return float(torch.min(self.mean(self.X)))


def expected_improvement(mu, s, fmin, jitter=0.01):
    s = torch.clamp(s, min=1e-10)
    u = (fmin - mu - jitter) / s
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    Phi = 0.5 * torch.special.erfc(-u / math.sqrt(2.0))
    return s * (u * Phi + phi)


def neg_lml_grad(spec: dict, X, Y, values: dict, noise: float, stated: dict, rung: int):
    """-LML and its gradient in the optimizer's softplus coordinates, one
    flat tensor per named parameter. The ladder's jitter is held constant:
    a jitter is never differentiated."""
    leaves = {k: torch.as_tensor(v, dtype=X.dtype, device=X.device).clone().requires_grad_(True)
              for k, v in values.items()}
    n = X.shape[0]
    Yn = normalize(Y)
    with torch.enable_grad():
        Ky, jitter, pad = gram(Kernel(spec, leaves).K(X, X), noise, stated, rung)
        Lc = torch.linalg.cholesky(Ky)
        del Ky
        a = torch.cholesky_solve(Yn, Lc)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(Lc))) + pad * math.log1p(jitter)
        nlml = 0.5 * (n * LOG_2_PI + logdet + torch.sum(Yn * a))
        grads = torch.autograd.grad(nlml, list(leaves.values()), allow_unused=True)
    out = {}
    for (k, leaf), g in zip(leaves.items(), grads):
        g = torch.zeros_like(leaf) if g is None else g
        # d theta / d u of softplus: sigmoid(u) = 1 - exp(-theta)
        out[k] = (g * -torch.expm1(-leaf.detach())).reshape(-1)
    return float(nlml.detach()), out

"""Manifold Relevance Determination (twin of
``gaussian_process_optimization_tpu/models/mrd.py``; GPy models/mrd.py).

V views Y_v share one variational latent q(X) = N(q_mu, diag(q_S)); each view
has its own ARD RBF kernel, inducing inputs and noise. The objective is
sum_v collapsed_bound_v(q(X)) - KL(q(X) || N(0, I)); a latent dimension
relevant to every view is shared, one weighted in a single view private.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..utils.transforms import POSITIVE
from .gplvm import gaussian_kl, minimize_one, packer_for, pca_init, uncertain_input_bound


@dataclasses.dataclass(frozen=True)
class MRD:
    kerns: tuple = ()             # one ARD RBF per view
    noise_vars: torch.Tensor = None  # (V,)
    Zs: tuple = ()                # one (M, Q) inducing set per view
    q_mu: torch.Tensor = None     # (N, Q), shared
    q_S: torch.Tensor = None      # (N, Q), shared
    Ys: tuple = ()                # V centred views

    @classmethod
    def create(cls, Ys, input_dim, num_inducing=10, noise_var=0.1, seed=0, dtype=None,
               device=None) -> "MRD":
        """The shared latent from the PCA of the stacked views (mrd.py _init_X
        'PCA'); ``device`` None means the card."""
        device = resolve_device(device)
        dtype = resolve_dtype(dtype, device)
        new = dict(dtype=dtype, device=device)
        Ys = [np.asarray(Y, dtype=float) for Y in Ys]
        n = Ys[0].shape[0]
        if any(Y.shape[0] != n for Y in Ys):
            raise ValueError("the views must share N")
        Ycs = [Y - Y.mean(0) for Y in Ys]
        mu0 = pca_init(np.concatenate(Ycs, axis=1), input_dim)
        rng = np.random.default_rng(seed)
        Zs = tuple(torch.as_tensor(mu0[rng.permutation(n)[:num_inducing]].copy(), **new)
                   for _ in Ys)
        return cls(kerns=tuple(RBF.create(input_dim, ARD=True, **new) for _ in Ys),
                   noise_vars=torch.full((len(Ys),), float(noise_var), **new), Zs=Zs,
                   q_mu=torch.as_tensor(mu0, **new),
                   q_S=torch.full((n, input_dim), 0.5, **new),
                   Ys=tuple(torch.as_tensor(Y, **new) for Y in Ycs))

    def elbo(self):
        bound = sum(uncertain_input_bound(k, Z, self.noise_vars[v], Y, self.q_mu, self.q_S)
                    for v, (k, Z, Y) in enumerate(zip(self.kerns, self.Zs, self.Ys)))
        return bound - gaussian_kl(self.q_mu, self.q_S)

    def log_marginal_likelihood(self):
        return self.elbo()

    def relevance(self):
        """(V, Q) ARD weights 1 / lengthscale^2 per view (mrd.py plot_scales)."""
        return torch.stack([1.0 / torch.square(k.lengthscale) for k in self.kerns])


def fit_mrd(model: MRD, maxiter=300):
    """L-BFGS over every view's hyperparameters and the shared q(X), one lane."""
    packer = packer_for(model, overrides={"q_S": POSITIVE, "noise_vars": POSITIVE},
                        fixed=("Ys",))
    return minimize_one(packer, model, maxiter)

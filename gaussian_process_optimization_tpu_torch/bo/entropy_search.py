"""Entropy search (twin of ``gaussian_process_optimization_tpu/bo/entropy_search.py``;
GPyOpt acquisitions/ES.py:11).

Representer points are drawn from an acquisition-proportional density (log EI by
default) by the ensemble sampler (``bo/mcmc_sampler.py``), the belief over the
minimizer p_min is estimated at them, and a candidate scores the predicted
change in the entropy of p_min after an observation there.

- :class:`AcquisitionEntropySearch` is the JAX package's Monte Carlo estimator:
  p_min is an argmin count over S joint samples of the representers, and a
  candidate's score is the expected entropy drop over exact rank-1 fantasy
  updates with common random numbers.
- :class:`AcquisitionEntropySearchEPMGP` is GPyOpt's estimator: p_min from EPMGP
  (``bo/epmgp.py``) with its derivatives, and the innovation-based predicted
  change of log p_min, averaged over the Gauss quantile fantasies W
  (ES.py:76-170).

Both refresh their representers before each argmax, as the reference does, and
have no gradient: the acquisition optimizer keeps its sweep's anchors. The
candidates are the rows of one batched computation each. The draws (the
sampler's, and the MC estimator's normals) come from ``generator``, or are
handed to :meth:`_update_representers`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import config
from ..ops import linalg
from .acquisitions import AcquisitionBase, get_quantiles
from .epmgp import joint_min
from .mcmc_sampler import ensemble_sample

# candidates scored per batched step of the MC estimator: its fantasy tensor
# is (chunk, fantasies, samples, representers)
_CHUNK = 128


def _joint_cov_with_representers(gp, post, Z, X):
    """(mu_x (n,), var_x (n,), cov_zx (R, n)): the noiseless predictive at X
    and its cross-covariance with the representers Z, from the exact
    posterior (GPy posterior.py:274)."""
    Kx_train, Kz_train = gp._cross(X), gp._cross(Z)
    tmp_x, tmp_z = gp._half(post, Kx_train), gp._half(post, Kz_train)
    mu_x = (Kx_train.mT @ post.alpha)[:, 0]
    var_x = torch.clamp(gp.kern.Kdiag(X) - torch.sum(torch.square(tmp_x), dim=0), min=1e-12)
    return mu_x, var_x, gp.kern.K(Z, X) - tmp_z.mT @ tmp_x


def _argmin_entropy(f):
    """Entropy of the argmin frequencies over the last axis but one of ``f
    (..., S, R)``, each count padded by 1e-6."""
    R = f.shape[-1]
    counts = torch.nn.functional.one_hot(torch.argmin(f, dim=-1), R).sum(dim=-2).to(f.dtype)
    p = (counts + 1e-6) / torch.sum(counts + 1e-6, dim=-1, keepdim=True)
    return -torch.sum(p * torch.log(p), dim=-1)


class _EntropySearchBase(AcquisitionBase):
    analytical_gradient_prediction = False

    def __init__(self, model, space, optimizer=None, cost_withGradients=None,
                 num_representer_points=50, burn_in_steps=50, proposal_function=None,
                 seed=0):
        super().__init__(model, space, optimizer, cost_withGradients)
        self.num_representer_points = num_representer_points
        self.burn_in_steps = burn_in_steps
        self.proposal_function = proposal_function
        self.seed = seed
        self.generator = None
        self._state = None

    def _generator(self, device):
        if self.generator is None:
            self.generator = torch.Generator(device=device).manual_seed(self.seed)
        return self.generator

    def _log_p(self, gp, post, fmin):
        """The sampling density: the user's proposal, else log EI with no margin."""
        if self.proposal_function is not None:
            def log_p(x):
                v = np.asarray(self.proposal_function(x.cpu().numpy()), dtype=float)
                return torch.as_tensor(v.reshape(-1), dtype=x.dtype, device=x.device)
            return log_p

        def log_p(x):
            mu, v = gp.predict(x, posterior=post)
            s = torch.sqrt(torch.clamp(v, min=config.variance_floor))
            phi, Phi, u = get_quantiles(0.0, fmin, mu, s)
            return torch.log(torch.clamp((s * (u * Phi + phi))[:, 0], min=1e-40))
        return log_p

    def _representers(self, gp, log_p, walker_draws=None):
        """The representer points: the last walkers of an ensemble chain of
        ``burn_in_steps`` steps, ``num_representer_points`` of them."""
        bounds = self.space.get_bounds()
        new = dict(dtype=gp.X.dtype, device=gp.X.device)
        lower = torch.as_tensor([b[0] for b in bounds], **new)
        upper = torch.as_tensor([b[1] for b in bounds], **new)
        R = self.num_representer_points
        _, walkers = ensemble_sample(log_p, lower, upper, R + R % 2, self.burn_in_steps,
                                     generator=self._generator(gp.X.device),
                                     draws=walker_draws)
        return walkers[:R]

    def device_args(self):
        if self._state is None:
            self._update_representers()
        gp, post, fmin = self.model.device_state()
        return gp, post, fmin, self._state

    def optimize(self, duplicate_manager=None):
        # representers for the current posterior before each argmax
        self._update_representers()
        return super().optimize(duplicate_manager=duplicate_manager)


class AcquisitionEntropySearch(_EntropySearchBase):
    """The Monte Carlo estimator: ``num_samples`` joint draws of the
    representers, ``num_fantasies`` fantasized observations per candidate."""

    def __init__(self, model, space, optimizer=None, sampler=None,
                 cost_withGradients=None, num_representer_points=50, burn_in_steps=50,
                 num_samples=400, num_fantasies=8, proposal_function=None, seed=0):
        super().__init__(model, space, optimizer, cost_withGradients, num_representer_points,
                         burn_in_steps, proposal_function, seed)
        self.num_samples = num_samples
        self.num_fantasies = num_fantasies

    def _update_representers(self, draws=None):
        """``draws``: ``{"walkers": EnsembleDraws, "W": (num_samples, R), "w_f":
        (num_samples,)}``, any of them, in place of the generator's."""
        draws = draws or {}
        gp, post, fmin = self.model.device_state()
        Z = self._representers(gp, self._log_p(gp, post, fmin), draws.get("walkers"))
        muZ, covZ = gp._raw_predict(Z, full_cov=True, posterior=post)
        covZ = covZ + 1e-8 * torch.eye(Z.shape[0], dtype=covZ.dtype, device=covZ.device)
        Lz, _, _ = linalg.jitchol(covZ)
        gen = self._generator(gp.X.device)
        new = dict(dtype=covZ.dtype, device=covZ.device)
        W = draws.get("W")
        W = (torch.randn((self.num_samples, Z.shape[0]), generator=gen, **new) if W is None
             else torch.as_tensor(W, **new))
        w_f = draws.get("w_f")
        w_f = (torch.randn((self.num_samples,), generator=gen, **new) if w_f is None
               else torch.as_tensor(w_f, **new))
        WL = W @ Lz.mT                # (S, R): the common random numbers' draws
        muZ = muZ[:, 0]
        self._state = (Z, muZ, Lz, W, w_f, WL, _argmin_entropy(muZ[None, :] + WL))

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        Z, muZ, Lz, W, w_f, WL, base_H = state
        mu_x, var_x, cov_zx = _joint_cov_with_representers(gp, posterior, Z, X)
        sy = torch.sqrt(var_x + gp.likelihood_variance)                     # (n,)
        gain = cov_zx.mT / torch.square(sy)[:, None]                         # (n, R)
        u = cov_zx.mT / sy[:, None]
        # the rank-1 downdate C - u u^T in sample space: with u = Lz a, a square
        # root of it is Lz (I - gamma a a^T), gamma = (1 - sqrt(1 - |a|^2)) / |a|^2,
        # so each base draw only loses gamma times its component along u
        a = linalg.solve_lower(Lz, u.mT).mT                                  # (n, R)
        a2 = torch.clamp(torch.sum(torch.square(a), dim=-1), 0.0, 1.0 - 1e-12)
        gamma = (1.0 - torch.sqrt(1.0 - a2)) / torch.clamp(a2, min=1e-12)
        c = gamma[:, None] * (a @ W.mT)                                      # (n, S)
        wf = w_f[:self.num_fantasies]
        out = []
        for i in range(0, X.shape[0], _CHUNK):
            sl = slice(i, i + _CHUNK)
            # y - mu_x = sy * wf for each fantasy: mu_new = muZ + gain (y - mu_x)
            mu_new = muZ + gain[sl, None, :] * (sy[sl, None, None] * wf[None, :, None])
            f = (mu_new[:, :, None, :] + WL
                 - c[sl, None, :, None] * u[sl, None, None, :])                 # (n, F, S, R)
            out.append(base_H - torch.mean(_argmin_entropy(f), dim=-1))
        return torch.cat(out)[:, None]


class AcquisitionEntropySearchEPMGP(_EntropySearchBase):
    """GPyOpt's estimator (ES.py:11 with util/epmgp.py): the value is the
    predicted relative entropy dH, higher is better, in the reference's sign
    convention (the host wrapper applies the minus)."""

    def __init__(self, model, space, optimizer=None, sampler=None,
                 cost_withGradients=None, num_samples=100, num_representer_points=50,
                 burn_in_steps=50, proposal_function=None, seed=0):
        super().__init__(model, space, optimizer, cost_withGradients, num_representer_points,
                         burn_in_steps, proposal_function, seed)
        self.num_samples = num_samples
        # W: Gauss quantiles for the stochastic change's average (ES.py:76-79)
        q = torch.linspace(1.0 / (num_samples + 1), 1.0 - 1.0 / (num_samples + 1),
                           num_samples, dtype=torch.float64)
        self._W = torch.special.ndtri(q)

    def _update_representers(self, draws=None):
        """``draws``: ``{"walkers": EnsembleDraws}`` in place of the generator's."""
        draws = draws or {}
        gp, post, fmin = self.model.device_state()
        log_p = self._log_p(gp, post, fmin)
        Z = self._representers(gp, log_p, draws.get("walkers"))
        repr_log = log_p(Z)
        # the joint belief at the representers with the noise (ES.py:108 predicts
        # with it, which keeps the covariance positive definite)
        muZ, covZ = gp._raw_predict(Z, full_cov=True, posterior=post)
        covZ = covZ + gp.likelihood_variance * torch.eye(Z.shape[0], dtype=covZ.dtype,
                                                         device=covZ.device)
        logP, dlogPdMu, dlogPdSigma, dlogPdMudMu = joint_min(muZ[:, 0], covZ,
                                                              with_derivatives=True)
        self._state = (Z, logP, dlogPdMu, dlogPdSigma, dlogPdMudMu, repr_log)

    def pure_raw_acq(self, gp, posterior, fmin, state, X):
        Z, logP, dlogPdMu, dlogPdSigma, dlogPdMudMu, repr_log = state
        _, var_x, cov_zx = _joint_cov_with_representers(gp, posterior, Z, X)
        R = Z.shape[0]
        ti, tj = torch.tril_indices(R, R, device=Z.device)
        W = self._W.to(dtype=cov_zx.dtype, device=cov_zx.device)
        dm = cov_zx.mT / torch.sqrt(var_x)[:, None]        # the mean's innovation (ES.py:199-207)
        dV_packed = -(dm[:, :, None] * dm[:, None, :])[:, ti, tj]
        # as the reference computes it: sum_{k, j} dm_k H[k, i, j] dm_j
        trace_term = torch.einsum("nk,kij,nj->ni", dm, dlogPdMudMu, dm)
        det_change = dV_packed @ dlogPdSigma.mT + 0.5 * trace_term        # (n, R)
        stoch = (dm @ dlogPdMu.mT)[:, :, None] * W                        # (n, R, S)
        pred = logP[None, :, None] + det_change[:, :, None] + stoch
        pred = pred - torch.logsumexp(pred, dim=1, keepdim=True)
        dHp = torch.sum(torch.exp(pred) * (pred + repr_log[None, :, None]), dim=1)
        return torch.mean(dHp, dim=-1)[:, None]

"""Expectation propagation, dense and sparse (twin of
``gaussian_process_optimization_tpu/models/ep.py``; GPy
inference/latent_function_inference/expectation_propagation.py: ``EP`` :253,
``EPDTC`` :443).

Moment matching is vectorized through ``Likelihood.moments_match_ep``. The
parallel mode (damped, the default) refreshes every site per sweep from one
Cholesky. The sequential mode makes GPy's site-by-site rank-1 updates
(``_local_updates`` :337, ``_update_rank1`` :103) in the order 0..N-1, an eager
loop of N small updates a sweep. Convergence is GPy's ``_stop_criteria`` (:233):
the mean squared site change below ``epsilon``. The evidence is GPy's
``_ep_marginal`` (:370) plus ``_log_Z_tilde`` (:360), zero prior mean, from
cavities recomputed at the converged posterior.

The posterior from sites, the evidence and EPDTC's bound take a leading lane
axis on ``K`` (the site-fixed objective of the alternated optimizer is called
with one lane); the sweeps run on one unbatched ``K``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import linalg

LOG_2_PI = math.log(2.0 * math.pi)
_TAU_EPS = 2.220446049250313e-16  # np.finfo(float).eps, the reference's site floor


@dataclasses.dataclass(frozen=True)
class EPPosterior:
    mu: torch.Tensor = None
    Sigma: torch.Tensor = None
    tau_site: torch.Tensor = None
    nu_site: torch.Tensor = None
    lml: torch.Tensor = None
    sweeps: int = 0
    site_change: float = 0.0  # the last sweep's, against the stopping epsilon


@dataclasses.dataclass(frozen=True)
class EPDTCPosterior:
    """Sparse EP in the Lm / LB form of the sparse prediction."""

    Lm: torch.Tensor = None   # chol(Kmm)
    LB: torch.Tensor = None   # chol(I + Ahat Ahat^T), Ahat = Lm^-1 Kmn sqrt(beta)
    c: torch.Tensor = None    # LB^-1 Lm^-1 Kmn (beta * mu_tilde)
    tau_site: torch.Tensor = None
    nu_site: torch.Tensor = None
    lml: torch.Tensor = None
    sweeps: int = 0
    site_change: float = 0.0


def _mv(K, v):
    return (K @ v[..., None])[..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------- dense EP
class _InvDiag(torch.autograd.Function):
    """diag(B^-1) from B's lower Cholesky factor L, as the column norms
    ||L^-1 e_i||^2, with L^-1 from ``linalg.tri_inv_lower`` (the
    triangular-inverse kernel on its diagonal blocks). The pullback of
    d = colsum(Li^2) is L_bar = -2 tril(Li^T Li diag(d_bar) Li^T)."""

    @staticmethod
    def forward(ctx, L):
        Li = linalg.tri_inv_lower(L)
        ctx.save_for_backward(Li)
        return torch.sum(Li * Li, dim=-2)

    @staticmethod
    def backward(ctx, d_bar):
        (Li,) = ctx.saved_tensors
        Lit = Li.mT
        return torch.tril(-2.0 * (Lit @ (Li * d_bar[..., None, :])) @ Lit)


def _gram(V, full):
    """V^T V, the product that Sigma = K - V^T V subtracts, or only its
    diagonal ||V e_i||^2 unless ``full``."""
    return V.mT @ V if full else torch.sum(V * V, dim=-2)


def _dense_posterior_from_sites(K, tau, nu, full=False):
    """GPy posteriorParams._recompute (:129): Sigma = K - K S^1/2 B^-1 S^1/2 K,
    mu = Sigma nu, with B = I + S^1/2 K S^1/2. Returns (mu, diag Sigma, L,
    Sigma if ``full`` else None).

    mu is K alpha with alpha = (K + S^-1)^-1 S^-1 nu = S^1/2 B^-1 S^-1/2 nu,
    one solve: the reference's nu - S^1/2 B^-1 S^1/2 K nu, equal in
    arithmetic, subtracts two terms ~nu^T K nu / nu^T Sigma nu times larger
    than their difference at a fitted point. diag Sigma takes, site by site,
    the form with the smaller rounding: K_ii - ||V e_i||^2 (V = L^-1 S^1/2 K)
    loses about eps K_ii, and (1 - ||L^-1 e_i||^2) / tau_i (S^1/2 Sigma S^1/2
    = I - B^-1) about eps / tau_i, so the second where tau_i K_ii > 1. At a
    fitted point K_ii can be ~1e3 times Sigma_ii.

    B is factored in float64 and its factor rounded to K's dtype
    (``linalg.jitchol_f64``), here and in :func:`ep_predict`. On an NVIDIA H100
    80GB HBM3 (700 W), at float64's converged sites of the classifier fitted
    there, the ladder's float32 ``cholesky_ex`` carried 3.7e-3 of the evidence,
    the host's float32 LAPACK 9.4e-5, the rounded float64 factor 2.3e-5
    (``prof_stages.ep_pieces``). The solves and the triangular inverse stay in
    K's dtype."""
    n = K.shape[-1]
    sW = torch.sqrt(torch.clamp(tau, min=_TAU_EPS))
    B = _eye(n, K) + sW[..., :, None] * K * sW[..., None, :]
    return _posterior_from_factor(K, tau, nu, linalg.jitchol_f64(B), full)


def _posterior_from_factor(K, tau, nu, L, full=False):
    """``_dense_posterior_from_sites`` from a given lower factor L of B."""
    tau_safe = torch.clamp(tau, min=_TAU_EPS)
    sW = torch.sqrt(tau_safe)
    V = linalg.solve_lower(L, sW[..., :, None] * K)
    Kdiag = torch.diagonal(K, dim1=-2, dim2=-1)
    VtV = _gram(V, full)
    sigma2 = Kdiag - (torch.diagonal(VtV, dim1=-2, dim2=-1) if full else VtV)
    informed = tau_safe * Kdiag > 1.0
    if bool(informed.any()):
        sigma2 = torch.where(informed, (1.0 - _InvDiag.apply(L)) / tau_safe, sigma2)
    alpha = sW * linalg.cho_solve(L, (nu / sW)[..., None])[..., 0]
    return _mv(K, alpha), sigma2, L, (K - VtV) if full else None


def _site_deltas(lik, y, tau, nu, mu_post, sigma2_post, eta, delta):
    """Cavity, moment match and GPy's site-delta form (cavityParams._update_i
    :27, gaussianApproximation._update_i :52), over every site at once."""
    sigma2 = torch.clamp(sigma2_post, min=1e-12)
    tau_cav = torch.clamp(1.0 / sigma2 - eta * tau, min=1e-12)
    v_cav = mu_post / sigma2 - eta * nu
    logZ, mu_hat, s2_hat = lik.moments_match_ep(y, tau_cav, v_cav)
    delta_tau = (delta / eta) * (1.0 / s2_hat - 1.0 / sigma2)
    delta_nu = (delta / eta) * (mu_hat / s2_hat - mu_post / sigma2)
    return delta_tau, delta_nu, logZ, tau_cav, v_cav


def _site_update(lik, y_i, tau_i, nu_i, mu_i, sigma2_i, eta, delta):
    """One site's sequential update: (d_tau, d_nu, new tau_i), with the
    positivity floor of gaussianApproximation._update_i (:60-66)."""
    sigma2_i = torch.clamp(sigma2_i, min=1e-12)
    tau_cav = torch.clamp(1.0 / sigma2_i - eta * tau_i, min=1e-12)
    v_cav = mu_i / sigma2_i - eta * nu_i
    _, mu_hat, s2_hat = lik.moments_match_ep(y_i[None], tau_cav[None], v_cav[None])
    mu_hat, s2_hat = mu_hat[0], s2_hat[0]
    d_tau = (delta / eta) * (1.0 / s2_hat - 1.0 / sigma2_i)
    d_nu = (delta / eta) * (mu_hat / s2_hat - mu_i / sigma2_i)
    tau_new_i = tau_i + d_tau
    d_tau = torch.where(tau_new_i < _TAU_EPS, _TAU_EPS - tau_i, d_tau)
    return d_tau, d_nu, torch.clamp(tau_new_i, min=_TAU_EPS)


def _site_change(tau, nu, tau_old, nu_old):
    """The larger of the mean squared changes of tau and of nu over a sweep."""
    return float(torch.maximum(torch.mean(torch.square(tau - tau_old)),
                               torch.mean(torch.square(nu - nu_old))))


def _run_sweeps(sweep, n, like, max_sweeps, epsilon):
    """The reference's init sweep from zero sites, then sweeps until
    ``_stop_criteria`` (both mean squared changes below ``epsilon``, after the
    second sweep) or ``max_sweeps``. Returns (tau, nu, sweeps, the last
    sweep's site change)."""
    tau_old = torch.zeros(n, dtype=like.dtype, device=like.device)
    nu_old = torch.zeros_like(tau_old)
    tau, nu = sweep(tau_old, nu_old)
    it = 1
    change = _site_change(tau, nu, tau_old, nu_old)
    while it < max_sweeps and not (it > 1 and change < epsilon):
        tau_old, nu_old = tau, nu
        tau, nu = sweep(tau, nu)
        it += 1
        change = _site_change(tau, nu, tau_old, nu_old)
    return tau, nu, it, change


def ep_inference(K, y, lik, mode="parallel", eta=1.0, delta=None, max_sweeps=50,
                 epsilon=1e-6) -> EPPosterior:
    """Dense EP (GPy EP.inference :253) on one ``K (N, N)``: 'parallel'
    (damped, delta 0.5 by default) or 'sequential' (rank-1 posterior updates
    site by site, delta 1.0 as in EPBase). Runs without autograd."""
    y = y.reshape(-1)
    n = K.shape[-1]
    if delta is None:
        delta = 0.5 if mode == "parallel" else 1.0

    if mode == "parallel":
        def sweep(tau, nu):
            mu, sigma2, _, _ = _dense_posterior_from_sites(K, tau, nu)
            d_tau, d_nu, _, _, _ = _site_deltas(lik, y, tau, nu, mu, sigma2, eta, delta)
            return torch.clamp(tau + d_tau, min=_TAU_EPS), nu + d_nu

    elif mode == "sequential":
        def sweep(tau, nu):
            mu, _, _, Sigma = _dense_posterior_from_sites(K, tau, nu, full=True)
            tau, nu = tau.clone(), nu.clone()
            for i in range(n):
                d_tau, d_nu, tau[i] = _site_update(lik, y[i], tau[i], nu[i], mu[i],
                                                   Sigma[i, i], eta, delta)
                nu[i] = nu[i] + d_nu
                # rank-1 posterior update (posteriorParams._update_rank1 :103)
                si = Sigma[:, i].clone()
                ci = d_tau / (1.0 + d_tau * si[i])
                mu = mu - (ci * (mu[i] + si[i] * d_nu) - d_nu) * si
                Sigma = Sigma - ci * si[:, None] * si[None, :]
            return tau, nu

    else:
        raise ValueError(f"unknown EP mode {mode!r}")

    with torch.no_grad():
        tau, nu, sweeps, change = _run_sweeps(sweep, n, K, max_sweeps, epsilon)
        mu, sigma2, L, Sigma = _dense_posterior_from_sites(K, tau, nu, full=True)
        lml = _dense_ep_lml(lik, y, tau, nu, mu, sigma2, L, eta)
    return EPPosterior(mu=mu, Sigma=Sigma, tau_site=tau, nu_site=nu, lml=lml, sweeps=sweeps,
                       site_change=change)


def _dense_ep_lml(lik, y, tau, nu, mu, sigma2, L, eta):
    """GPy _ep_marginal (:370) + _log_Z_tilde (:360), zero prior mean, from
    the posterior of ``_dense_posterior_from_sites`` (mu, diag Sigma, L). The
    Gaussian term's nu^T Sigma nu is read as nu . mu (mu = Sigma nu by
    definition): at a fitted point Sigma = K - V^T V cancels ~1e3-fold, and
    the reference's sum(nu * (Sigma @ nu)) carries float32's rounding of V^T V
    into the evidence. At the classifier fitted on an NVIDIA H100 80GB HBM3
    (700 W) the float32 evidence reads 6.8e-2 from float64 with that
    quadratic, 9.7e-7 with the port's forms (``prof_stages.EP_FORMS``)."""
    sigma2 = torch.clamp(sigma2, min=1e-12)
    tau_cav = torch.clamp(1.0 / sigma2 - eta * tau, min=1e-12)
    v_cav = mu / sigma2 - eta * nu
    logZ_hat, _, _ = lik.moments_match_ep(y, tau_cav, v_cav)
    Z_tilde = torch.sum(
        logZ_hat + 0.5 * LOG_2_PI + 0.5 * torch.log1p(tau / tau_cav)
        - 0.5 * torch.square(nu) / (tau_cav + tau)
        + 0.5 * (v_cav * ((tau / tau_cav) * v_cav - 2.0 * nu) / (tau_cav + tau)), dim=-1)
    n = tau.shape[-1]
    gauss = 0.5 * (-n * LOG_2_PI - linalg.logdet_from_chol(L) + torch.sum(nu * mu, dim=-1))
    return gauss + Z_tilde


def ep_probit_inference(K, y, sweeps=30, damping=0.5, jitter=1e-8, mode="parallel"):
    """The probit-classification wrapper (the reference keeps it for its API)."""
    from .likelihoods import Bernoulli

    return ep_inference(K, y, Bernoulli(), mode=mode, delta=damping, max_sweeps=sweeps,
                        epsilon=0.0 if mode == "parallel" else 1e-10)


def ep_predict(K_train, Ks, kdiag_s, post: EPPosterior):
    """Predictive latent mean and variance from EP sites (GPML 3.60-3.61)."""
    n = K_train.shape[-1]
    sW = torch.sqrt(torch.clamp(post.tau_site, min=_TAU_EPS))
    L = linalg.jitchol_f64(_eye(n, K_train) + sW[:, None] * K_train * sW[None, :])
    z = sW * linalg.cho_solve(L, (sW * (K_train @ post.nu_site))[:, None])[:, 0]
    mu = Ks.mT @ (post.nu_site - z)
    V = linalg.solve_lower(L, sW[:, None] * Ks)
    return mu, torch.clamp(kdiag_s - torch.sum(torch.square(V), 0), min=1e-15)


# ---------------------------------------------------------------- EPDTC
def _dtc_posterior_from_sites(Lm, Kmn, tau, nu):
    """GPy posteriorParamsDTC._recompute (:175): Sigma = Kmn^T (Kmm + Kmn S
    Knm)^-1 Kmn, mu = Sigma nu. Returns (mu, diag Sigma, V = L^-1 Kmn, L)."""
    LLT = Lm @ Lm.mT + (Kmn * tau[..., None, :]) @ Kmn.mT
    L, _, _ = linalg.jitchol(LLT)
    V = linalg.solve_lower(L, Kmn)
    Sigma_diag = torch.clamp(torch.sum(V * V, dim=-2), min=_TAU_EPS)
    mu = (V.mT @ (V @ nu[..., None]))[..., 0]
    return mu, Sigma_diag, V, L


def epdtc_inference(Kmm, Kmn, Kdiag, y, lik, mode="parallel", eta=1.0, delta=None,
                    max_sweeps=50, epsilon=1e-6, psi2n=None, sites=None) -> EPDTCPosterior:
    """Sparse EP on inducing points (GPy EPDTC :443): EP sweeps on the DTC
    posterior, then the heteroscedastic VarDTC bound at the pseudo-targets
    mu_tilde = nu / tau with precision beta = tau (:457-481), plus the
    log_Z_tilde correction (:521).

    Uncertain inputs (sparse_gp_classification.py:103): Kmn = psi1^T, Kdiag the
    per-point psi0 and ``psi2n`` the per-point (N, M, M) psi2; the sweeps keep
    the DTC posterior of psi1 and the bound replaces Knm beta Kmn with
    sum_n beta_n psi2_n.

    ``sites=(tau, nu)`` skips the sweeps and evaluates the bound at fixed
    sites, the hyperparameter half of the alternated optimizer (EPBase
    ep_mode='alternated', :188); only this form is differentiable, and ``Kmm``
    / ``Kmn`` may then carry a lane axis."""
    Kdiag = Kdiag.reshape(Kdiag.shape[:-1] + (-1,))
    y = y.reshape(-1)
    n = Kmn.shape[-1]
    if delta is None:
        delta = 0.5 if mode == "parallel" else 1.0
    Lm, _, _ = linalg.jitchol(Kmm)

    if sites is not None:
        tau, nu, sweeps, change = sites[0].reshape(-1), sites[1].reshape(-1), 0, 0.0
    else:
        if mode == "parallel":
            def sweep(tau, nu):
                mu, Sigma_diag, _, _ = _dtc_posterior_from_sites(Lm, Kmn, tau, nu)
                d_tau, d_nu, _, _, _ = _site_deltas(lik, y, tau, nu, mu, Sigma_diag, eta,
                                                    delta)
                return torch.clamp(tau + d_tau, min=_TAU_EPS), nu + d_nu

        elif mode == "sequential":
            def sweep(tau, nu):
                # posteriorParamsDTC._update_rank1 (:149): a rank-1 update of
                # LLT, refactored, Sigma_diag and mu refreshed; O(m^3 + n m^2)
                # a site
                mu, Sigma_diag, _, L = _dtc_posterior_from_sites(Lm, Kmn, tau, nu)
                LLT = L @ L.mT
                tau, nu = tau.clone(), nu.clone()
                for i in range(n):
                    d_tau, d_nu, tau[i] = _site_update(lik, y[i], tau[i], nu[i], mu[i],
                                                       Sigma_diag[i], eta, delta)
                    nu[i] = nu[i] + d_nu
                    ki = Kmn[:, i]
                    LLT = LLT + d_tau * ki[:, None] * ki[None, :]
                    Li, _, _ = linalg.jitchol(LLT)
                    V = linalg.solve_lower(Li, Kmn)
                    Sigma_diag = torch.clamp(torch.sum(V * V, dim=0), min=_TAU_EPS)
                    si = V.mT @ V[:, i]
                    mu = mu + (d_nu - d_tau * mu[i]) * si
                return tau, nu

        else:
            raise ValueError(f"unknown EP mode {mode!r}")

        with torch.no_grad():
            tau, nu, sweeps, change = _run_sweeps(sweep, n, Kmm, max_sweeps, epsilon)

    # the heteroscedastic VarDTC bound at the EP pseudo-data
    mu_post, Sigma_diag, _, _ = _dtc_posterior_from_sites(Lm, Kmn, tau, nu)
    tau_safe = torch.clamp(tau, min=_TAU_EPS)
    mu_tilde = nu / tau_safe
    beta = tau_safe

    # log_Z_tilde (EPDTC._log_Z_tilde :521), cavities at the converged posterior
    sigma2 = torch.clamp(Sigma_diag, min=1e-12)
    tau_cav = torch.clamp(1.0 / sigma2 - eta * tau, min=1e-12)
    v_cav = mu_post / sigma2 - eta * nu
    logZ_hat, _, _ = lik.moments_match_ep(y, tau_cav, v_cav)
    mu_cav = v_cav / tau_cav
    s2_sum = 1.0 / tau_cav + 1.0 / tau_safe
    Z_tilde = torch.sum(logZ_hat + 0.5 * LOG_2_PI + 0.5 * torch.log(s2_sum)
                        + 0.5 * torch.square(mu_cav - mu_tilde) / s2_sum, dim=-1)

    # VarDTC with heteroscedastic precision (var_dtc.py:266-277)
    m = Kmm.shape[-1]
    if psi2n is None:
        Ahat = linalg.solve_lower(Lm, Kmn * torch.sqrt(beta))
        A = Ahat @ Ahat.mT
    else:
        P = torch.einsum("n,...nij->...ij", beta, psi2n)
        A = linalg.solve_lower(Lm, linalg.solve_lower(Lm, P).mT).mT
    LB, _, _ = linalg.jitchol(_eye(m, Kmm) + A)
    tmp = linalg.solve_lower(Lm, Kmn)
    c = linalg.solve_lower(LB, (tmp @ (beta * mu_tilde)[:, None]))
    lml = (-0.5 * n * LOG_2_PI
           + 0.5 * torch.sum(torch.log(beta))
           - 0.5 * torch.sum(beta * torch.square(mu_tilde))
           - 0.5 * (torch.sum(beta * Kdiag, dim=-1)
                    - torch.diagonal(A, dim1=-2, dim2=-1).sum(-1))
           - torch.sum(torch.log(torch.diagonal(LB, dim1=-2, dim2=-1)), dim=-1)
           + 0.5 * torch.sum(torch.square(c), dim=(-2, -1))
           + Z_tilde)
    return EPDTCPosterior(Lm=Lm, LB=LB, c=c, tau_site=tau, nu_site=nu, lml=lml, sweeps=sweeps,
                          site_change=change)


def epdtc_predict(Lm, LB, c, Kms, kdiag_s):
    """Sparse-EP predictive latent mean and variance (the Lm / LB algebra of
    ``models/sparse.py``'s prediction)."""
    tmp = linalg.solve_lower(Lm, Kms)
    tmp2 = linalg.solve_lower(LB, tmp)
    mu = (tmp2.mT @ c)[:, 0]
    var = kdiag_s - torch.sum(torch.square(tmp), 0) + torch.sum(torch.square(tmp2), 0)
    return mu, torch.clamp(var, min=1e-15)

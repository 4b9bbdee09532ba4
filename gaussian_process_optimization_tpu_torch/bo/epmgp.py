"""EPMGP: the expectation-propagation approximation of p_min over a joint
Gaussian (twin of ``gaussian_process_optimization_tpu/bo/epmgp.py``; GPyOpt
util/epmgp.py, itself RoBO's port of Cunningham, Hennig and Lacoste-Julien,
"Gaussian probabilities and expectation propagation", 2011).

``joint_min(mu, Sigma)`` gives log p(x_k = argmin f) for each of the D points of
N(mu, Sigma): for every k, EP over the D - 1 truncation factors 1[f_k <= f_l]
(``min_faktor`` / ``lt_factor``, epmgp.py:124-287), normalized across k.

The D per-k problems run as one batch: each rank-1 site update acts on all of
them at once, and the sites and sweeps stay sequential (epmgp.py:103-180). A
problem stops sweeping on its own convergence, failure or sweep count, as under
the reference's vmapped while loop. The reference's z < -6 (failure) and z > 6
(inactive factor) branches are masked selects.

The JAX package's documented deviation is kept: the derivative renormalization
uses the outer product Zm Zm^T where GPyOpt's Matlab-derived code takes
``Zm.T * Zm`` elementwise (checked against finite differences in the tests).
"""
from __future__ import annotations

import torch

SQ2 = 1.4142135623730951
EPS = 1.1920929e-07  # float32 eps, the reference's message floor (epmgp.py:47)
L2P = 1.8378770664093453  # log(2 pi)


def _log_relative_gauss(z):
    """(e, logPhi, flag): e = N(z) / Phi(z); flag -1 is a numerical failure
    (z < -6), +1 an inactive factor (z > 6), 0 regular (epmgp.py:268-280)."""
    logphi = -0.5 * (z * z + L2P)
    logPhi = torch.special.log_ndtr(z)
    e = torch.exp(logphi - logPhi)
    flag = (z > 6.0).to(torch.int8) - (z < -6.0).to(torch.int8)
    inactive = flag == 1
    e = torch.where(flag == 0, e, (~inactive).to(z.dtype))
    logPhi = torch.where(flag == 0, logPhi,
                         torch.where(inactive, torch.zeros_like(z), torch.full_like(z, -1e12)))
    return e, logPhi, flag


def _lt_factor(s, l, M, V, mp, p, gamma):
    """One EP update of the factor 1[f_s <= f_l] per problem (epmgp.py:215-266).
    ``s``, ``l`` (K,) indices, ``M`` (K, D), ``V`` (K, D, D), ``mp``, ``p`` (K,).
    Returns (Mnew, Vnew, pnew, mpnew, logS, d, failed)."""
    k = torch.arange(M.shape[0], device=M.device)
    cVc = (V[k, l, l] - 2.0 * V[k, s, l] + V[k, s, s]) / 2.0
    Vc = (V[k, :, l] - V[k, :, s]) / SQ2
    cM = (M[k, l] - M[k, s]) / SQ2
    cVnic = torch.clamp(cVc / (1.0 - p * cVc), min=0.0)
    cmni = cM + cVnic * (p * cM - mp)
    z = cmni / torch.sqrt(cVnic + 1e-25)
    z = torch.where(torch.isnan(z), torch.full_like(z, -float("inf")), z)
    e, lP, flag = _log_relative_gauss(z)

    # the regular branch (flag == 0)
    cVnic_safe = torch.clamp(cVnic, min=1e-25)
    alpha = e / torch.sqrt(cVnic_safe)
    beta = alpha * (alpha * cVnic + cmni)
    r = beta / torch.clamp(1.0 - beta, min=1e-25)
    pnew0 = r / cVnic_safe
    mpnew0 = r * (alpha + cmni / cVnic_safe) + alpha
    dp0 = torch.maximum(-p + EPS, gamma * (pnew0 - p))
    dmp0 = torch.maximum(-mp + EPS, gamma * (mpnew0 - mp))
    beta_safe = torch.clamp(beta, min=1e-300)
    logS0 = (lP - 0.5 * (torch.log(beta_safe) - torch.log(torch.clamp(p + dp0, min=1e-300))
                         - torch.log(cVnic_safe))
             + (alpha * alpha) / (2.0 * beta_safe) * cVnic)

    regular, inactive, failed = flag == 0, flag == 1, flag == -1
    zero = torch.zeros_like(p)
    # the inactive branch (flag == 1) removes the message
    dp = torch.where(regular, dp0, torch.where(inactive, -p, zero))
    dmp = torch.where(regular, dmp0, torch.where(inactive, -mp, zero))
    d = torch.where(regular, torch.maximum(dmp, dp),
                    torch.where(inactive, zero, torch.full_like(p, float("nan"))))
    logS = torch.where(regular, logS0, zero)
    denom = 1.0 + dp * cVc
    Vnew = V - (dp / denom)[:, None, None] * (Vc[:, :, None] * Vc[:, None, :])
    Mnew = M + ((dmp - cM * dp) / denom)[:, None] * Vc
    Vnew = torch.where(failed[:, None, None], V, Vnew)
    Mnew = torch.where(failed[:, None], M, Mnew)
    failed = failed | torch.isnan(Vnew).flatten(1).any(dim=1)
    return Mnew, Vnew, p + dp, mp + dmp, logS, d, failed


def _min_factors(Mu, Sigma, gamma=1.0, max_sweeps=50, conv_tol=1e-3):
    """EP for every k at once: log P(f_k <= f_l for all l != k) under N(Mu,
    Sigma) and its derivatives in Mu and Sigma (epmgp.py:124-213). Returns
    (logZ (D,), dlogZdMu (D, D), dlogZdMudMu (D, D, D), dlogZdSigma (D, T)),
    T = D (D + 1) / 2, lower triangle row by row."""
    D = Mu.shape[0]
    dev, dt = Mu.device, Mu.dtype
    ks = torch.arange(D, device=dev)
    # site i of problem k is the factor against l = i + (i >= k)
    iidx = torch.arange(D - 1, device=dev)
    lidx = iidx[None, :] + (iidx[None, :] >= ks[:, None]).to(iidx.dtype)   # (D, D-1)

    M = Mu.expand(D, D).clone()
    V = Sigma.expand(D, D, D).clone()
    P = torch.zeros(D, D - 1, dtype=dt, device=dev)
    MP, logS = torch.zeros_like(P), torch.zeros_like(P)
    failed = torch.zeros(D, dtype=torch.bool, device=dev)
    active = torch.ones(D, dtype=torch.bool, device=dev)
    sweeps = 0
    while True:
        diff = torch.zeros(D, dtype=dt, device=dev)
        for i in range(D - 1):
            Mn, Vn, pn, mpn, lSn, d, fail_i = _lt_factor(ks, lidx[:, i], M, V, MP[:, i],
                                                         P[:, i], gamma)
            d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
            # a failed problem freezes (the reference breaks out of its loop);
            # a problem that stopped sweeping keeps its state
            keep = ~failed & active
            M = torch.where(keep[:, None], Mn, M)
            V = torch.where(keep[:, None, None], Vn, V)
            P[:, i] = torch.where(keep, pn, P[:, i])
            MP[:, i] = torch.where(keep, mpn, MP[:, i])
            logS[:, i] = torch.where(keep, lSn, logS[:, i])
            diff = diff + torch.where(keep, torch.abs(d), torch.zeros_like(d))
            failed = failed | (fail_i & active)
        sweeps += 1
        active = active & ~failed & (torch.abs(diff) >= conv_tol)
        if sweeps >= max_sweeps or not bool(active.any()):
            break

    # logZ (epmgp.py:168-196). C: identity / sqrt 2 with row k = -1 / sqrt 2,
    # column k removed
    eye = torch.eye(D, dtype=dt, device=dev)
    Cfull = torch.where((ks[None, :, None] == ks[:, None, None]),
                        torch.full((D, D, D), -1.0 / SQ2, dtype=dt, device=dev),
                        (eye / SQ2).expand(D, D, D))                     # (k, row, col)
    C = torch.gather(Cfull, 2, lidx[:, None, :].expand(D, D, D - 1))     # (D, D, D-1)
    R = C * torch.sqrt(torch.clamp(P, min=0.0))[:, None, :]
    r = (C @ MP[:, :, None])[..., 0]                                      # (D, D)
    mpm = torch.sum(torch.where(MP != 0.0, MP * MP / torch.clamp(P, min=1e-300),
                                torch.zeros_like(MP)), dim=1)
    s_sum = torch.sum(logS, dim=1)
    IRSR = torch.eye(D - 1, dtype=dt, device=dev) + R.mT @ Sigma @ R
    rSr = torch.sum(r * (r @ Sigma), dim=1)
    A = R @ torch.linalg.solve(IRSR, R.mT)
    A = 0.5 * (A + A.mT)
    b = Mu[None, :] + r @ Sigma
    Ab = (A @ b[:, :, None])[..., 0]
    _, logdet = torch.linalg.slogdet(IRSR)
    logZ = 0.5 * (rSr - torch.sum(b * Ab, dim=1) - logdet) + r @ Mu + s_sum - 0.5 * mpm
    logZ = torch.where(failed, torch.full_like(logZ, -float("inf")), logZ)

    f1, f2 = failed[:, None], failed[:, None, None]
    dlogZdMu = torch.where(f1, torch.zeros_like(r), r - Ab)
    dlogZdMudMu = torch.where(f2, torch.zeros_like(A), -A)
    outer = r[:, :, None] * Ab[:, None, :]
    dS = -A - 2.0 * outer + r[:, :, None] * r[:, None, :] + Ab[:, :, None] * Ab[:, None, :]
    dS = 0.5 * (dS + dS.mT - torch.diag_embed(torch.diagonal(dS, dim1=-2, dim2=-1)))
    ti, tj = torch.tril_indices(D, D, device=dev)
    dlogZdSigma = torch.where(f1, torch.zeros((), dtype=dt, device=dev), dS[:, ti, tj])
    return logZ, dlogZdMu, dlogZdMudMu, dlogZdSigma


def joint_min(mu, Sigma, with_derivatives: bool = False, max_sweeps: int = 50):
    """log p_min over the D points of N(mu, Sigma) (epmgp.py joint_min:55-122):
    logP (D,), and with derivatives also dlogPdMu (D, D), dlogPdSigma (D,
    D(D+1)/2) (lower triangle, row by row) and dlogPdMudMu (D, D, D)."""
    mu = mu.reshape(-1)
    logP, dMu, dMudMu, dSig = _min_factors(mu, Sigma, max_sweeps=max_sweeps)
    logP = torch.where(torch.isinf(logP), torch.full_like(logP, -500.0), logP)
    # normalize across k (:100-105)
    s = torch.logsumexp(logP, dim=0)
    logP_n = logP - s
    if not with_derivatives:
        return logP_n
    p_hat = torch.exp(logP_n)
    Zm = p_hat @ dMu
    Zs = p_hat @ dSig
    gg = torch.einsum("k,kij->ij", p_hat, dMudMu + dMu[:, :, None] * dMu[:, None, :])
    adds = -gg + Zm[:, None] * Zm[None, :]
    return logP_n, dMu - Zm[None, :], dSig - Zs[None, :], dMudMu + adds[None, :, :]


def pack_tril(S):
    """A symmetric (D, D) matrix's lower triangle, row by row: the layout of
    ``joint_min``'s dlogPdSigma axis."""
    ti, tj = torch.tril_indices(S.shape[0], S.shape[0], device=S.device)
    return S[ti, tj]

"""The GPLVM family's psi statistics (twin of part of
``gaussian_process_optimization_tpu/models/gplvm.py``; GPy
kern/src/psi_comp/rbf_psi_comp.py).

Only the RBF kernel's closed-form Gaussian expectations are here so far, for
the sparse classifier with uncertain inputs (``models/classification.py``); the
GPLVM models themselves are not ported yet.
"""
from __future__ import annotations

import torch


def rbf_psi_stats_n(kern, Z, mu, S):
    """(psi0, psi1, psi2n) of an RBF kernel under q(x_n) = N(mu_n, diag(S_n)),
    psi2 per point, ``(N, M, M)`` (GPy kern.psi2n):
      psi0 = sum_n <k(x_n, x_n)> = N variance
      psi1[n, m] = <k(x_n, z_m)>
      psi2n[n, m, m'] = <k(x_n, z_m) k(x_n, z_m')>
    ARD lengthscales are supported."""
    var = kern.variance
    D = mu.shape[1]
    ls2 = torch.square(kern.lengthscale).expand(D)
    psi0 = mu.shape[0] * var

    denom1 = S + ls2[None, :]
    dist1 = torch.square(mu[:, None, :] - Z[None, :, :]) / denom1[:, None, :]
    logdet1 = torch.sum(torch.log1p(S / ls2[None, :]), dim=1)
    psi1 = var * torch.exp(-0.5 * torch.sum(dist1, dim=2) - 0.5 * logdet1[:, None])

    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    dZ2 = torch.square(Z[:, None, :] - Z[None, :, :])
    denom2 = 2.0 * S + ls2[None, :]
    logdet2 = torch.sum(torch.log1p(2.0 * S / ls2[None, :]), dim=1)
    cross = torch.exp(-0.25 * torch.sum(dZ2 / ls2, dim=2))  # independent of n
    diff = mu[:, None, None, :] - Zbar[None, :, :, :]
    quad = torch.sum(torch.square(diff) / denom2[:, None, None, :], dim=3)
    psi2n = torch.square(var) * cross[None, :, :] * torch.exp(
        -quad - 0.5 * logdet2[:, None, None])
    return psi0, psi1, psi2n

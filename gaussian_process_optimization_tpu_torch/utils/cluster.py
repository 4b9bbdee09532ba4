"""Greedy time-series clustering with the offset GP (twin of
``gaussian_process_optimization_tpu/utils/cluster.py``; GPy
``util/cluster_with_offset.py``: ``cluster``, ``get_log_likelihood_offset``).

Starting from singleton clusters, the greedy loop joins the pair whose joint
offset-GP log likelihood most exceeds the sum of the two separate fits, until
no join improves it. A pair fit shares one RBF GP across the two series with a
trainable input offset on the second (``models/zoo.py GPOffsetRegression``)
and the reference's N(0, 20) prior on the offset.

The reference fits O(K^2) models one after another, each at its own size.
Here every candidate is right-padded to one fixed row budget (padded rows
become identity rows of the Gram), and all stale candidates of a round are the
lanes of one ``ops/lbfgs.minimize`` call, in place of the JAX package's
``vmap``: one batched (lanes, n_max, n_max) K build per trial (the K kernel on
a card in float32), one batched Cholesky. Positive parameters go through
softplus (paramz's Logexp).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import config, resolve_device, resolve_dtype
from ..kernels.stationary import RBF
from ..models.gp import LOG_2_PI, ExactCore
from ..ops import lbfgs
from .transforms import Positive

_POS = Positive()
_OFFSET_PRIOR_STD = 20.0  # the reference's GPy.priors.Gaussian(0, 20) on the offset


def _masked_lml(U, X, Y, sel, mask, with_offset):
    """LML per lane of the (offset-)GP at packed ``U (B, 4)`` = [raw noise, raw
    variance, raw lengthscale, offset]: the positive leaves through softplus,
    rows with ``sel`` = 1 shifted by the offset; ``X (B, n, 1)``, ``Y (B, n,
    p)``, ``sel`` and ``mask (B, n)``. The Gram is the exact GP's: noise +
    1e-8 on the diagonal (floored in float32), padded rows identity rows."""
    noise = _POS.forward(U[:, 0]) + 1e-6
    kern = RBF(input_dim=X.shape[-1], active_dims=None, variance=_POS.forward(U[:, 1]),
               lengthscale=_POS.forward(U[:, 2]))
    Xs = X + (U[:, 3, None] * sel)[..., None] if with_offset else X
    K = kern.K(Xs)
    noise = noise + config.noise_jitter
    if K.dtype == torch.float32:
        noise = torch.clamp(noise, min=config.f32_noise_floor)
    Ky = K * (mask[:, :, None] * mask[:, None, :])
    Ky = Ky + torch.diag_embed(noise[:, None] * mask + (1.0 - mask))
    Yc = Y * mask[..., None]
    logdet, quad, *_ = ExactCore.apply(Ky, Yc, None, False)
    return 0.5 * (-torch.sum(mask, dim=-1) * Y.shape[-1] * LOG_2_PI
                  - Y.shape[-1] * logdet - quad)


def _fit_lanes(U0, Xb, Yb, selb, maskb, with_offset, maxiter):
    """:func:`fit_batch`, and each lane's fitted packed leaves ``U (B, 4)``."""

    def obj(U):
        pen = 0.5 * (U[:, 3] / _OFFSET_PRIOR_STD) ** 2 if with_offset else 0.0
        return -_masked_lml(U, Xb, Yb, selb, maskb, with_offset) + pen

    res = lbfgs.minimize(obj, U0, maxiter=maxiter)
    with torch.no_grad():
        ll = _masked_lml(res.x, Xb, Yb, selb, maskb, with_offset)
    off = res.x[:, 3] if with_offset else torch.zeros_like(ll)
    return ll, off, res.x.detach()


def fit_batch(U0, Xb, Yb, selb, maskb, with_offset, maxiter):
    """Fit every lane in one L-BFGS call; ``(lml at each lane's optimum,
    offset)``. The reported value is the likelihood (the reference compares
    ``m.log_likelihood()``), the prior only shapes the fit."""
    return _fit_lanes(U0, Xb, Yb, selb, maskb, with_offset, maxiter)[:2]


def lane_lml(U, items, dtype=None, device=None):
    """The offset-GP log likelihood of each ``(X, Y, sel)`` of ``items`` at
    its packed leaves, a row of ``U (B, 4)``, in ``dtype`` on ``device``: a
    clustering lane re-evaluated, in float64 for one, at the leaves a float32
    fit reached. Returns a float64 numpy array."""
    dtype, device = _where(device, dtype)
    with torch.no_grad():
        ll = _masked_lml(torch.as_tensor(np.asarray(U), dtype=dtype, device=device),
                         *_own_rows(items, dtype, device), True)
    return ll.double().cpu().numpy()


def f32_effective(U):
    """``U (B, 4)`` with each lane's raw noise moved to the noise float32
    evaluates (softplus(raw) + 1e-6 + ``config.noise_jitter``, floored at
    ``config.f32_noise_floor``), so that float64 builds the same Gram from it."""
    U = torch.as_tensor(np.asarray(U), dtype=torch.float64).clone()
    extra = 1e-6 + config.noise_jitter
    noise = torch.clamp(_POS.forward(U[:, 0]) + extra, min=config.f32_noise_floor)
    U[:, 0] = _POS.inverse(noise - extra)
    return U.numpy()


def _own_rows(items, dtype, device):
    """``pad_stack`` of ``items`` to their own largest row count."""
    return pad_stack(items, max(x.shape[0] for x, _, _ in items), dtype, device)


def pad_stack(items, n_max, dtype, device):
    """``items``: (X, Y, sel) triples; each right-padded to ``n_max`` rows,
    stacked as lanes, with masks."""
    Xb, Yb, selb, maskb = [], [], [], []
    for X, Y, sel in items:
        n, d = X.shape
        p = n_max - n
        Xb.append(np.vstack([X, np.zeros((p, d))]))
        Yb.append(np.vstack([Y, np.zeros((p, Y.shape[1]))]))
        selb.append(np.concatenate([sel, np.zeros(p)]))
        maskb.append((np.arange(n_max) < n).astype(float))
    return tuple(torch.as_tensor(np.stack(a), dtype=dtype, device=device)
                 for a in (Xb, Yb, selb, maskb))


def _u0(lanes, dtype, device):
    raw1 = float(_POS.inverse(torch.tensor(1.0, dtype=torch.float64)))
    return torch.tensor([raw1, raw1, raw1, 0.0], dtype=dtype, device=device).expand(lanes, 4)


def _where(device, dtype):
    device = resolve_device(device)
    return resolve_dtype(dtype, device), device


def _fit_one(X, Y, sel, with_offset, maxiter, where):
    Xb, Yb, selb, maskb = pad_stack([(X, Y, sel)], X.shape[0], *where)
    ll, off = fit_batch(_u0(1, *where), Xb, Yb, selb, maskb, with_offset, maxiter)
    return float(ll[0]), float(off[0])


def get_log_likelihood(inputs, data, clust, maxiter=80, device=None, dtype=None):
    """LL of the union of ``clust`` with no offsets (cluster_with_offset.py
    get_log_likelihood:8): ``(ll, 0.0)``. ``device`` None means the card."""
    where = _where(device, dtype)
    X = np.vstack([np.asarray(inputs[p], dtype=float) for p in clust])
    Y = np.vstack([np.asarray(data[p], dtype=float).T for p in clust])
    ll, _ = _fit_one(X, Y, np.zeros(X.shape[0]), False, maxiter, where)
    return ll, 0.0


def get_log_likelihood_offset(inputs, data, clust, maxiter=80, device=None, dtype=None):
    """LL of the union of ``clust`` with a trainable offset between its two
    members (get_log_likelihood_offset:47): ``(ll, offset)``; one member falls
    back to the offset-free fit."""
    if len(clust) == 1:
        return get_log_likelihood(inputs, data, clust, maxiter=maxiter, device=device,
                                  dtype=dtype)
    assert len(clust) == 2, "the greedy loop only ever joins pairs"
    where = _where(device, dtype)
    i, j = clust
    Xi = np.asarray(inputs[i], dtype=float)
    Xj = np.asarray(inputs[j], dtype=float)
    Y = np.vstack([np.asarray(data[i], dtype=float).T, np.asarray(data[j], dtype=float).T])
    sel = np.concatenate([np.zeros(Xi.shape[0]), np.ones(Xj.shape[0])])
    return _fit_one(np.vstack([Xi, Xj]), Y, sel, True, maxiter, where)


def cluster(data, inputs, verbose=False, maxiter=80, device=None, dtype=None, history=None,
            max_lanes=None):
    """Greedy offset-GP clustering (cluster_with_offset.py cluster:92).

    ``data``: one ``(S, T_p)`` array per series (S outputs over T_p times);
    ``inputs``: their ``(T_p, 1)`` time stamps, the reference's layout.
    Returns the clusters, lists of the original series' indices. Each round's
    stale singles and pairs are the lanes of one fit, all padded to the total
    row count; ``device`` None means the card. ``max_lanes`` caps the lanes
    of one fit (a round then takes several; each lane's fit is its own, so
    only the memory changes).

    ``history``, a list, receives one list a round: each lane fitted that
    round as ``(members, (X, Y, sel), U, ll)`` (``members`` the tuples of
    series of its one or two clusters; ``U`` the lane's fitted packed leaves,
    for :func:`lane_lml`)."""
    where = _where(device, dtype)
    data = [np.asarray(d, dtype=float) for d in data]
    inputs = [np.asarray(x, dtype=float) for x in inputs]
    n_max = sum(x.shape[0] for x in inputs)

    active = [[p] for p in range(len(data))]
    loglikes = np.full(len(active), np.nan)
    pairll = np.full((len(active), len(active)), np.nan)
    pairoff = np.zeros_like(pairll)

    def run_stale():
        jobs, slots = [], []
        for i in range(len(active)):
            if np.isnan(loglikes[i]):
                jobs.append((inputs[i], data[i].T, np.zeros(inputs[i].shape[0])))
                slots.append(("s", i))
            for j in range(i):
                if np.isnan(pairll[i, j]):
                    jobs.append((np.vstack([inputs[i], inputs[j]]),
                                 np.vstack([data[i].T, data[j].T]),
                                 np.concatenate([np.zeros(inputs[i].shape[0]),
                                                 np.ones(inputs[j].shape[0])])))
                    slots.append(("p", i, j))
        if not jobs:
            return
        step = max_lanes or len(jobs)
        parts = []
        for k in range(0, len(jobs), step):
            part = jobs[k:k + step]
            parts.append([a.cpu().numpy() for a in _fit_lanes(
                _u0(len(part), *where), *pad_stack(part, n_max, *where), True, maxiter)])
        ll, off, U = (np.concatenate(a) for a in zip(*parts))
        if history is not None:
            history.append([(tuple(tuple(active[i]) for i in w[1:]), jobs[k], U[k], float(ll[k]))
                            for k, w in enumerate(slots)])
        for k, w in enumerate(slots):
            if w[0] == "s":
                loglikes[w[1]] = ll[k]
            else:
                pairll[w[1], w[2]] = ll[k]
                pairoff[w[1], w[2]] = off[k]

    it = 0
    while True:
        it += 1
        if verbose:
            print(f"cluster iteration {it}: {len(active)} clusters")
        run_stale()
        improvement = pairll - (loglikes[None, :] + loglikes[:, None])
        if np.all(np.isnan(improvement)):
            break
        top = np.unravel_index(np.nanargmax(improvement), improvement.shape)
        if not improvement[top] > 0:
            break
        i, j = top  # join j into i
        # the pair fit adds the offset to cluster j's rows (sel == 1), so j is
        # aligned onto i by +offset (the reference's model shifts the other way)
        active[i].extend(active[j])
        inputs[i] = np.vstack([inputs[i], inputs[j] + pairoff[i, j]])
        data[i] = np.hstack([data[i], data[j]])
        del inputs[j], data[j], active[j]
        pairll[:, i] = np.nan
        pairll[i, :] = np.nan
        pairll = np.delete(np.delete(pairll, j, 0), j, 1)
        pairoff = np.delete(np.delete(pairoff, j, 0), j, 1)
        loglikes[i] = np.nan
        loglikes = np.delete(loglikes, j)
        if len(active) == 1:
            break
    return active

"""Split / changepoint and generic multi-output kernels (twin of
``gaussian_process_optimization_tpu/kernels/split.py``; GPy splitKern.py:10,
:80, multioutput_kern.py:22).

- ``SplitKern`` / ``DEtime``: two conditions, the condition index in the last
  column; same-condition pairs take the base kernel, cross-condition pairs the
  conditioned cross-covariance k(x, Xp) k(Xp, x') / k(Xp, Xp) through the split
  point ``Xp`` (a trainable leaf, as in the reference: its name is not a data
  name). One masked select over the index column.
- ``MultioutputKern``: per-output kernels and optional cross-covariance
  callables, zero where a pair has none; the output index in the last column.
  One object given for two outputs is one latent function (full
  cross-covariance); the identity test is the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import Kernel, as_leaf


@dataclasses.dataclass(frozen=True)
class SplitKern(Kernel):
    kern: Kernel = None
    Xp: torch.Tensor = None  # (1, D) split point

    @classmethod
    def create(cls, kernel, Xp):
        Xp = as_leaf(Xp, like=kernel._leaf_like())
        Xp = Xp.reshape(1, -1) if Xp.ndim < 2 else Xp
        return cls(input_dim=kernel.input_dim + 1, kern=kernel, Xp=Xp)

    def _cross(self, Xa, Xb):
        k1 = self.kern.K(Xa, self.Xp)                   # (n, 1)
        k2 = self.kern.K(self.Xp, Xb)                   # (1, m)
        k3 = self.kern.K(self.Xp, self.Xp)[..., 0, 0]
        return (k1 @ k2) / k3[..., None, None]

    def K(self, X, X2=None):
        X2 = X if X2 is None else X2
        Xb, X2b = X[..., :-1], X2[..., :-1]
        same = X[..., :, None, -1] == X2[..., None, :, -1]
        return torch.where(same, self.kern.K(Xb, X2b), self._cross(Xb, X2b))

    def Kdiag(self, X):
        return self.kern.Kdiag(X[..., :-1])


@dataclasses.dataclass(frozen=True)
class DEtime(Kernel):
    """SplitKern whose second condition's first ``idx_p`` rows replicate the
    first condition's (splitKern.py:10): those rows are relabelled to
    condition 0, which gives the reference's copied rows and columns.
    Condition blocks are contiguous (0s, then 1s)."""

    split: SplitKern = None
    idx_p: int = 0

    @classmethod
    def create(cls, kernel, idx_p, Xp):
        return cls(input_dim=kernel.input_dim + 1, split=SplitKern.create(kernel, Xp),
                   idx_p=idx_p)

    def _relabel(self, X):
        n = X.shape[0]
        if self.idx_p <= 0 or self.idx_p > n / 2:
            return X
        idx = X[:, -1]
        n0 = torch.sum(idx == idx[0])
        pos = torch.arange(n, device=X.device)
        in_replica = (pos >= n0) & (pos < n0 + self.idx_p)
        new_idx = torch.where(in_replica, idx[0], idx)
        return torch.cat([X[:, :-1], new_idx[:, None]], dim=1)

    def K(self, X, X2=None):
        assert X2 is None, "DEtime.K is defined for X2=None (splitKern.py:19)"
        return self.split.K(self._relabel(X))

    def Kdiag(self, X):
        return self.split.Kdiag(self._relabel(X))


@dataclasses.dataclass(frozen=True)
class MultioutputKern(Kernel):
    """kernels: one per output; cross_fns: {(i, j): callable(Xa, Xb)}."""

    kernels: tuple = ()
    cross_fns: dict = None

    @classmethod
    def create(cls, kernels, cross_covariances=None):
        kernels = tuple(kernels)
        return cls(input_dim=kernels[0].input_dim + 1, kernels=kernels,
                   cross_fns=dict(cross_covariances or {}))

    def _block(self, i, j, Xa, Xb):
        if i == j or self.kernels[i] is self.kernels[j]:
            return self.kernels[i].K(Xa, Xb)
        fn = (self.cross_fns or {}).get((i, j))
        if fn is not None:
            return fn(Xa, Xb)
        return Xa.new_zeros(Xa.shape[:-1] + (Xb.shape[-2],))

    def K(self, X, X2=None):
        X2 = X if X2 is None else X2
        idx1, idx2 = X[..., -1], X2[..., -1]
        Xb, X2b = X[..., :-1], X2[..., :-1]
        out = 0.0
        nl = len(self.kernels)
        for i in range(nl):
            mi = (idx1 == i).to(X.dtype)[..., :, None]
            for j in range(nl):
                mj = (idx2 == j).to(X.dtype)[..., None, :]
                out = out + mi * mj * self._block(i, j, Xb, X2b)
        return out

    def Kdiag(self, X):
        idx, Xb = X[..., -1], X[..., :-1]
        return sum((idx == i).to(X.dtype) * k.Kdiag(Xb) for i, k in enumerate(self.kernels))

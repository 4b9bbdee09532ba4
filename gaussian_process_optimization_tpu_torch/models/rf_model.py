"""Random-forest surrogate (twin of ``gaussian_process_optimization_tpu/models/rf_model.py``;
GPyOpt models/rfmodel.py:8 ``RFModel``).

GPyOpt wraps sklearn's RandomForestRegressor and takes the predictive variance
as the mean over trees of (tree prediction - forest mean)^2. This is the port's
own copy of the JAX package's self-contained numpy CART forest, with the same
variance convention and the same draws for the same seed: tree induction is
branchy integer work, so it runs on the host, as in the reference, and its
acquisitions take the host path (it has no ``device_state``).
"""
from __future__ import annotations

import numpy as np


class _Tree:
    """CART regression tree, variance-reduction splits, stored as flat arrays."""

    def __init__(self, max_depth=12, min_samples_split=2, max_features=None, rng=None):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)

    def fit(self, X, y):
        n, d = X.shape
        self.feature, self.threshold = [], []
        self.left, self.right, self.value = [], [], []

        def build(idx, depth):
            node = len(self.feature)
            self.feature.append(-1)
            self.threshold.append(0.0)
            self.left.append(-1)
            self.right.append(-1)
            self.value.append(float(np.mean(y[idx])))
            if depth >= self.max_depth or len(idx) < self.min_samples_split:
                return node
            k = self.max_features or d
            feats = self.rng.permutation(d)[:k]
            best = None
            parent_sse = np.sum((y[idx] - np.mean(y[idx])) ** 2)
            for f in feats:
                xs = X[idx, f]
                order = np.argsort(xs)
                xs_s, ys_s = xs[order], y[idx][order]
                # candidate thresholds between distinct consecutive values
                cum = np.cumsum(ys_s)
                cum2 = np.cumsum(ys_s**2)
                total, total2 = cum[-1], cum2[-1]
                m = len(xs_s)
                i = np.arange(1, m)
                valid = xs_s[1:] != xs_s[:-1]
                if not np.any(valid):
                    continue
                sse_l = cum2[:-1] - cum[:-1] ** 2 / i
                nr = m - i
                sse_r = (total2 - cum2[:-1]) - (total - cum[:-1]) ** 2 / nr
                sse = np.where(valid, sse_l + sse_r, np.inf)
                j = int(np.argmin(sse))
                if sse[j] < (best[0] if best else parent_sse - 1e-12):
                    thr = 0.5 * (xs_s[j] + xs_s[j + 1])
                    best = (sse[j], f, thr)
            if best is None:
                return node
            _, f, thr = best
            mask = X[idx, f] <= thr
            li, ri = idx[mask], idx[~mask]
            if len(li) == 0 or len(ri) == 0:
                return node
            self.feature[node] = int(f)
            self.threshold[node] = float(thr)
            self.left[node] = build(li, depth + 1)
            self.right[node] = build(ri, depth + 1)
            return node

        build(np.arange(n), 0)
        self.feature = np.asarray(self.feature)
        self.threshold = np.asarray(self.threshold)
        self.left = np.asarray(self.left)
        self.right = np.asarray(self.right)
        self.value = np.asarray(self.value)
        return self

    def predict(self, X):
        n = X.shape[0]
        node = np.zeros(n, dtype=int)
        active = self.feature[node] >= 0
        while np.any(active):
            rows = np.where(active)[0]
            f = self.feature[node[rows]]
            thr = self.threshold[node[rows]]
            go_left = X[rows, f] <= thr
            node[rows] = np.where(go_left, self.left[node[rows]], self.right[node[rows]])
            active = self.feature[node] >= 0
        return self.value[node]


class RandomForest:
    def __init__(self, n_estimators=100, max_depth=12, max_features="third", seed=0):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.max_features = max_features
        self.rng = np.random.default_rng(seed)
        self.trees = []

    def fit(self, X, y):
        n, d = X.shape
        if self.max_features == "third":
            k = max(1, d // 3)
        else:
            k = self.max_features or d
        self.trees = []
        for _ in range(self.n_estimators):
            idx = self.rng.integers(0, n, size=n)  # bootstrap
            t = _Tree(max_depth=self.max_depth, max_features=k,
                      rng=np.random.default_rng(self.rng.integers(2**31)))
            t.fit(X[idx], y[idx])
            self.trees.append(t)
        return self

    def predict_all(self, X):
        return np.stack([t.predict(X) for t in self.trees], axis=0)  # (T, n)


class RFModel:
    """(rfmodel.py:8): predict -> (forest mean, std) where var = mean over trees of
    (tree prediction - mean)^2."""

    analytical_gradient_prediction = False

    def __init__(self, verbose=False, n_estimators=100, max_depth=12, seed=0):
        self.verbose = verbose
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.seed = seed
        self.model = None

    def updateModel(self, X_all, Y_all, X_new=None, Y_new=None):
        X_all = np.atleast_2d(np.asarray(X_all, dtype=float))
        Y_all = np.asarray(Y_all, dtype=float).reshape(len(X_all))
        self.X = X_all
        self.Y = Y_all[:, None]
        self.model = RandomForest(self.n_estimators, self.max_depth, seed=self.seed)
        self.model.fit(X_all, Y_all)

    def predict(self, X):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        preds = self.model.predict_all(X)  # (T, n)
        m = preds.mean(0)[:, None]
        v = ((preds - m.T) ** 2).mean(0)[:, None]
        return m, np.sqrt(np.maximum(v, 1e-10))

    def predict_withGradients(self, X):
        raise NotImplementedError("RF surrogate has no analytic gradients (rfmodel.py)")

    def get_fmin(self):
        return float(self.predict(self.X)[0].min())

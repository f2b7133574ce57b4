"""Random-forest regressor (numpy, from scratch) — the MOO-STAGE surrogate.

The paper's evaluation-function learner ([10][39]) uses random forests for
speed and robustness on small tabular design-feature data; sklearn is not
available in this environment so we implement bagged CART regression trees
directly.  Property-tested in tests/test_moo.py (fits simple functions,
beats mean-predictor).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0


class RegressionTree:
    def __init__(self, max_depth=6, min_leaf=2, n_features=None, rng=None):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.n_features = n_features
        self.rng = rng or np.random.default_rng(0)
        self.nodes: list[_Node] = []

    def fit(self, X, y):
        self.nodes = []
        self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node(value=float(y.mean())))
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or y.std() < 1e-12:
            return idx
        d = X.shape[1]
        k = self.n_features or max(1, int(np.sqrt(d)))
        feats = self.rng.choice(d, size=min(k, d), replace=False)
        best = (None, None, np.inf)
        for f in feats:
            xs = X[:, f]
            order = np.argsort(xs)
            xs_s, y_s = xs[order], y[order]
            csum = np.cumsum(y_s)
            csq = np.cumsum(y_s ** 2)
            n = len(y_s)
            for cut in range(self.min_leaf, n - self.min_leaf):
                if xs_s[cut] == xs_s[cut - 1]:
                    continue
                nl, nr = cut, n - cut
                sl, sr = csum[cut - 1], csum[-1] - csum[cut - 1]
                ql, qr = csq[cut - 1], csq[-1] - csq[cut - 1]
                sse = (ql - sl * sl / nl) + (qr - sr * sr / nr)
                if sse < best[2]:
                    best = (f, 0.5 * (xs_s[cut] + xs_s[cut - 1]), sse)
        if best[0] is None:
            return idx
        f, thr, _ = best
        mask = X[:, f] <= thr
        node = self.nodes[idx]
        node.feature, node.threshold = int(f), float(thr)
        node.left = self._build(X[mask], y[mask], depth + 1)
        node.right = self._build(X[~mask], y[~mask], depth + 1)
        return idx

    def predict(self, X):
        out = np.empty(len(X))
        for i, x in enumerate(X):
            n = 0
            while self.nodes[n].feature >= 0:
                nd = self.nodes[n]
                n = nd.left if x[nd.feature] <= nd.threshold else nd.right
            out[i] = self.nodes[n].value
        return out


class RandomForest:
    """Bagged regression trees; the paper's surrogate learner."""

    def __init__(self, n_trees=24, max_depth=6, min_leaf=2, seed=0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.seed = seed
        self.trees: list[RegressionTree] = []
        self._fallback = 0.0

    def fit(self, X, y):
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        self.trees = []
        self._fallback = float(y.mean()) if len(y) else 0.0
        if len(y) < 4:
            return self
        rng = np.random.default_rng(self.seed)
        n = len(y)
        for t in range(self.n_trees):
            idx = rng.integers(0, n, size=n)
            tree = RegressionTree(self.max_depth, self.min_leaf,
                                  rng=np.random.default_rng(self.seed + t + 1))
            tree.fit(X[idx], y[idx])
            self.trees.append(tree)
        return self

    def predict(self, X):
        X = np.atleast_2d(np.asarray(X, float))
        if not self.trees:
            return np.full(len(X), self._fallback)
        return np.mean([t.predict(X) for t in self.trees], axis=0)

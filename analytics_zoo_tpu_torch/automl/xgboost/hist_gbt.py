"""Dependency-free histogram gradient-boosted trees (xgboost fallback; a
copy of ``analytics_zoo_tpu/automl/xgboost/hist_gbt.py``).

The reference's AutoXGBoost trains xgboost models on cluster CPUs
(pyzoo/zoo/orca/automl/xgboost/XGBoost.py); xgboost is not baked into the
TPU image, and tree training is host-side by design (trees do not map to
the XLA compute path). This module supplies a small second-order
gradient-boosting engine — the same algorithm family as xgboost's
``tree_method=hist`` — so AutoXGBRegressor/AutoXGBClassifier are fully
executable out of the box:

* per-feature quantile binning to uint8 (``max_bins`` <= 256);
* depth-wise tree growth; each node split maximises the standard
  second-order gain  GL^2/(HL+lam) + GR^2/(HR+lam) - G^2/(H+lam)
  from per-(feature, bin) gradient/hessian histograms;
* squared-error objective for regression, logistic for binary
  classification, one-tree-per-class softmax for multiclass;
* sklearn-style surface: ``fit(X, y)``, ``predict``, ``predict_proba``,
  ``get_params``/``set_params`` — the subset AutoXGBoost and the zouwu
  Xgb recipes use.

When the real xgboost IS importable it is preferred (auto_xgb.py picks the
backend at construction); numbers from the two backends are not meant to
be bit-identical, only comparably good on the tabular workloads the
reference targets.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class _Node:
    __slots__ = ("feature", "bin_threshold", "threshold", "left", "right",
                 "value")

    def __init__(self):
        self.feature = -1           # -1 => leaf
        self.bin_threshold = 0      # split on bin index (training)
        self.threshold = 0.0        # raw-value threshold (prediction)
        self.left: Optional[int] = None
        self.right: Optional[int] = None
        self.value = 0.0


class _Tree:
    """One regression tree on binned features; flat node arena."""

    def __init__(self, max_depth: int, min_child_weight: float,
                 reg_lambda: float, gamma: float):
        self.max_depth = max_depth
        self.min_child_weight = min_child_weight
        self.reg_lambda = reg_lambda
        self.gamma = gamma
        self.nodes: List[_Node] = []

    def _leaf_value(self, g: float, h: float) -> float:
        return -g / (h + self.reg_lambda)

    def fit(self, binned: np.ndarray, bin_edges: List[np.ndarray],
            grad: np.ndarray, hess: np.ndarray) -> "_Tree":
        n_features = binned.shape[1]

        def build(idx: np.ndarray, depth: int) -> int:
            node = _Node()
            node_id = len(self.nodes)
            self.nodes.append(node)
            g_sum, h_sum = float(grad[idx].sum()), float(hess[idx].sum())
            node.value = self._leaf_value(g_sum, h_sum)
            if depth >= self.max_depth or len(idx) < 2:
                return node_id

            parent_score = g_sum * g_sum / (h_sum + self.reg_lambda)
            best = (self.gamma, -1, -1)        # (gain, feature, bin)
            sub = binned[idx]
            gi, hi = grad[idx], hess[idx]
            for f in range(n_features):
                nb = len(bin_edges[f]) + 1
                if nb < 2:
                    continue
                bf = sub[:, f]
                g_hist = np.bincount(bf, weights=gi, minlength=nb)
                h_hist = np.bincount(bf, weights=hi, minlength=nb)
                gl = np.cumsum(g_hist)[:-1]    # left sums for split at bin b
                hl = np.cumsum(h_hist)[:-1]
                gr, hr = g_sum - gl, h_sum - hl
                ok = (hl >= self.min_child_weight) & \
                     (hr >= self.min_child_weight)
                if not ok.any():
                    continue
                gain = (gl * gl / (hl + self.reg_lambda) +
                        gr * gr / (hr + self.reg_lambda) - parent_score)
                gain = np.where(ok, gain, -np.inf)
                b = int(np.argmax(gain))
                if gain[b] > best[0]:
                    best = (float(gain[b]), f, b)

            _, f, b = best
            if f < 0:
                return node_id
            node.feature = f
            node.bin_threshold = b
            node.threshold = float(bin_edges[f][b])
            mask = binned[idx, f] <= b
            node.left = build(idx[mask], depth + 1)
            node.right = build(idx[~mask], depth + 1)
            return node_id

        build(np.arange(binned.shape[0]), 0)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        out = np.empty(len(x), np.float64)
        # iterative traversal, vectorized per node frontier
        stack: List[Tuple[int, np.ndarray]] = [(0, np.arange(len(x)))]
        while stack:
            node_id, idx = stack.pop()
            node = self.nodes[node_id]
            if node.feature < 0 or node.left is None:
                out[idx] = node.value
                continue
            mask = x[idx, node.feature] <= node.threshold
            stack.append((node.left, idx[mask]))
            stack.append((node.right, idx[~mask]))
        return out


def _quantile_bins(x: np.ndarray, max_bins: int) -> List[np.ndarray]:
    """Per-feature interior bin edges (len <= max_bins - 1)."""
    edges = []
    qs = np.linspace(0, 1, max_bins + 1)[1:-1]
    for f in range(x.shape[1]):
        e = np.unique(np.quantile(x[:, f], qs))
        edges.append(e.astype(np.float64))
    return edges


def _bin_data(x: np.ndarray, edges: List[np.ndarray]) -> np.ndarray:
    binned = np.empty(x.shape, np.int16)
    for f, e in enumerate(edges):
        binned[:, f] = np.searchsorted(e, x[:, f], side="left")
    return binned


class _BaseGBT:
    # xgboost params that are accepted silently — they tune execution, not
    # the model, and have no equivalent here. "objective"/"eval_metric" are
    # deliberately NOT in this set: objective selects the loss, and this
    # backend only implements squared-error/logistic/softmax — swallowing a
    # non-default objective would silently train the wrong model.
    _EXECUTION_PARAMS = frozenset({
        "n_jobs", "nthread", "verbosity", "tree_method", "device",
        "early_stopping_rounds", "booster"})

    def __init__(self, n_estimators: int = 100, max_depth: int = 6,
                 learning_rate: float = 0.3, reg_lambda: float = 1.0,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 subsample: float = 1.0, max_bins: int = 256,
                 random_state: int = 0, **_ignored):
        unused = set(_ignored) - self._EXECUTION_PARAMS
        if unused:
            # real xgboost warns about unused parameters too — without
            # this, a typo'd search-space key silently searches a no-op axis
            import logging
            logging.getLogger("analytics_zoo_tpu_torch").warning(
                "hist_gbt: parameters %s are not used", sorted(unused))
        self.n_estimators = int(n_estimators)
        self.max_depth = int(max_depth)
        self.learning_rate = float(learning_rate)
        self.reg_lambda = float(reg_lambda)
        self.gamma = float(gamma)
        self.min_child_weight = float(min_child_weight)
        self.subsample = float(subsample)
        self.max_bins = int(max_bins)
        self.random_state = int(random_state)
        self._trees: List[List[_Tree]] = []    # [round][output]
        self._base = 0.0

    # sklearn-ish param plumbing (what auto_xgb/model selection needs)
    def get_params(self, deep: bool = True) -> dict:
        return {k: getattr(self, k) for k in (
            "n_estimators", "max_depth", "learning_rate", "reg_lambda",
            "gamma", "min_child_weight", "subsample", "max_bins",
            "random_state")}

    def set_params(self, **params) -> "_BaseGBT":
        for k, v in params.items():
            setattr(self, k, v)
        return self

    # objective interface ---------------------------------------------------
    def _n_outputs(self, y) -> int:
        raise NotImplementedError

    def _base_score(self, y) -> np.ndarray:
        raise NotImplementedError

    def _grad_hess(self, raw: np.ndarray, y: np.ndarray):
        raise NotImplementedError

    def fit(self, x, y, eval_set=None, verbose=False, **_) -> "_BaseGBT":
        x = np.ascontiguousarray(np.asarray(x, np.float64))
        y = np.asarray(y)
        rng = np.random.RandomState(self.random_state)
        n, _ = x.shape
        k = self._n_outputs(y)
        self._edges = _quantile_bins(x, self.max_bins)
        binned = _bin_data(x, self._edges)
        raw = np.tile(self._base_score(y), (n, 1))     # (n, k)
        self._trees = []
        for _round in range(self.n_estimators):
            grad, hess = self._grad_hess(raw, y)       # (n, k) each
            if self.subsample < 1.0:
                keep = rng.rand(n) < self.subsample
                gs, hs = grad * keep[:, None], hess * keep[:, None]
            else:
                gs, hs = grad, hess
            round_trees = []
            for j in range(k):
                t = _Tree(self.max_depth, self.min_child_weight,
                          self.reg_lambda, self.gamma)
                t.fit(binned, self._edges, gs[:, j], hs[:, j])
                round_trees.append(t)
                raw[:, j] += self.learning_rate * t.predict(x)
            self._trees.append(round_trees)
        return self

    def _raw_predict(self, x) -> np.ndarray:
        x = np.ascontiguousarray(np.asarray(x, np.float64))
        k = len(self._trees[0]) if self._trees else 1
        raw = np.tile(self._base, (len(x), 1)) if np.ndim(self._base) \
            else np.full((len(x), k), self._base)
        for round_trees in self._trees:
            for j, t in enumerate(round_trees):
                raw[:, j] += self.learning_rate * t.predict(x)
        return raw


class ZooGBTRegressor(_BaseGBT):
    """Squared-error histogram GBT (xgboost.XGBRegressor stand-in)."""

    def _n_outputs(self, y) -> int:
        return 1

    def _base_score(self, y) -> np.ndarray:
        self._base = float(np.mean(y))
        return np.asarray([self._base])

    def _grad_hess(self, raw, y):
        grad = raw[:, 0] - np.asarray(y, np.float64)
        return grad[:, None], np.ones_like(grad)[:, None]

    def predict(self, x) -> np.ndarray:
        return self._raw_predict(x)[:, 0]


class ZooGBTClassifier(_BaseGBT):
    """Logistic / softmax histogram GBT (xgboost.XGBClassifier stand-in)."""

    def _n_outputs(self, y) -> int:
        self.classes_ = np.unique(y)
        if len(self.classes_) < 2:
            raise ValueError(
                "ZooGBTClassifier needs at least 2 classes in y; got "
                f"{self.classes_!r} (single-class folds/slices cannot be "
                "fit — filter them before training)")
        return 1 if len(self.classes_) == 2 else len(self.classes_)

    def _base_score(self, y) -> np.ndarray:
        if len(self.classes_) <= 2:
            p = float(np.mean(np.asarray(y) == self.classes_[-1]))
            p = min(max(p, 1e-7), 1 - 1e-7)
            self._base = float(np.log(p / (1 - p)))
            return np.asarray([self._base])
        self._base = np.zeros(len(self.classes_))
        return self._base

    def _grad_hess(self, raw, y):
        y = np.asarray(y)
        if len(self.classes_) <= 2:
            p = 1.0 / (1.0 + np.exp(-raw[:, 0]))
            t = (y == self.classes_[-1]).astype(np.float64)
            return (p - t)[:, None], (p * (1 - p) + 1e-12)[:, None]
        z = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(z)
        p = e / e.sum(axis=1, keepdims=True)
        onehot = (y[:, None] == self.classes_[None, :]).astype(np.float64)
        return p - onehot, p * (1 - p) + 1e-12

    def predict_proba(self, x) -> np.ndarray:
        raw = self._raw_predict(x)
        if len(self.classes_) <= 2:
            p = 1.0 / (1.0 + np.exp(-raw[:, 0]))
            return np.stack([1 - p, p], -1)
        z = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self.classes_[np.argmax(self.predict_proba(x), axis=1)]

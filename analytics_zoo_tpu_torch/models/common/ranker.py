"""Ranking metrics (a copy of ``analytics_zoo_tpu/models/common/ranker.py``;
parity: pyzoo/zoo/models/common/ranker.py — evaluateNDCG/evaluateMAP over
query-grouped relations)."""

from __future__ import annotations

import numpy as np


def ndcg(labels: np.ndarray, scores: np.ndarray, k: int = 10) -> float:
    order = np.argsort(-scores)
    gains = (2.0 ** labels[order][:k] - 1.0)
    discounts = 1.0 / np.log2(np.arange(2, gains.size + 2))
    dcg = float(np.sum(gains * discounts))
    ideal = np.sort(labels)[::-1][:k]
    idcg = float(np.sum((2.0 ** ideal - 1.0) /
                        np.log2(np.arange(2, ideal.size + 2))))
    return dcg / idcg if idcg > 0 else 0.0


def mean_average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    order = np.argsort(-scores)
    rel = labels[order] > 0
    if not rel.any():
        return 0.0
    precision_at_hit = np.cumsum(rel) / np.arange(1, rel.size + 1)
    return float(np.sum(precision_at_hit * rel) / rel.sum())

"""Streaming metrics (counterpart of ``analytics_zoo_tpu/orca/learn/
metrics.py``): each metric is an (init_state, update, compute) triple over a
small dict of device tensors, accumulated batch by batch in the eval step
and read once at the end. The state layout and the arithmetic follow the
JAX package's metrics one to one."""

from __future__ import annotations

from typing import Dict, Optional

import torch

EPS = 1e-7


class Metric:
    """Base streaming metric: state ``{"total", "count"}``, ``compute`` is
    their ratio."""

    name: str = "metric"

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        z = torch.zeros((), device=device)
        return {"total": z, "count": z.clone()}

    def update(self, state, y_true, y_pred, weight=None):
        raise NotImplementedError

    def compute(self, state) -> torch.Tensor:
        return state["total"] / state["count"].clamp_min(EPS)

    @staticmethod
    def _weighted(values, weight: Optional[torch.Tensor]):
        values = values.reshape(values.shape[0], -1).float().mean(-1)
        if weight is None:
            weight = torch.ones_like(values)
        return (values * weight).sum(), weight.sum()

    def _accumulate(self, state, values, weight):
        t, c = self._weighted(values, weight)
        return {"total": state["total"] + t, "count": state["count"] + c}


class MAE(Metric):
    name = "mae"

    def update(self, state, y_true, y_pred, weight=None):
        return self._accumulate(
            state, (y_pred.reshape(y_true.shape) - y_true).abs(), weight)


class MSE(Metric):
    name = "mse"

    def update(self, state, y_true, y_pred, weight=None):
        d = y_pred.reshape(y_true.shape) - y_true
        return self._accumulate(state, d * d, weight)


class RMSE(MSE):
    name = "rmse"

    def compute(self, state):
        return torch.sqrt(super().compute(state))


class Accuracy(Metric):
    """Sparse labels with multi-class outputs: argmax match; one output:
    threshold at 0.5."""
    name = "accuracy"

    def update(self, state, y_true, y_pred, weight=None):
        if y_pred.dim() >= 2 and y_pred.shape[-1] > 1:
            pred = y_pred.argmax(-1)
            true = (y_true if y_true.dim() < y_pred.dim()
                    else y_true.argmax(-1))
            correct = pred == true.to(pred.dtype)
        else:
            p = y_pred.reshape(y_true.shape)
            correct = (p > 0.5) == (y_true > 0.5)
        return self._accumulate(state, correct.float(), weight)


class SparseCategoricalAccuracy(Metric):
    name = "sparse_categorical_accuracy"

    def update(self, state, y_true, y_pred, weight=None):
        pred = y_pred.argmax(-1)
        correct = pred == y_true.reshape(pred.shape).to(pred.dtype)
        return self._accumulate(state, correct.float(), weight)


class CategoricalAccuracy(Metric):
    name = "categorical_accuracy"

    def update(self, state, y_true, y_pred, weight=None):
        correct = y_pred.argmax(-1) == y_true.argmax(-1)
        return self._accumulate(state, correct.float(), weight)


class BinaryAccuracy(Metric):
    name = "binary_accuracy"

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def update(self, state, y_true, y_pred, weight=None):
        p = y_pred.reshape(y_true.shape)
        correct = (p > self.threshold).float() == y_true
        return self._accumulate(state, correct.float(), weight)


class TopKCategoricalAccuracy(Metric):
    def __init__(self, k: int = 5):
        self.k = k
        self.name = f"top{k}_accuracy"

    def update(self, state, y_true, y_pred, weight=None):
        true = (y_true if y_true.dim() == y_pred.dim() - 1
                else y_true.argmax(-1))
        true = true.reshape(y_pred.shape[:-1]).long()
        topk = y_pred.topk(self.k, dim=-1).indices
        correct = (topk == true[..., None]).any(-1)
        return self._accumulate(state, correct.float(), weight)


class Top5Accuracy(TopKCategoricalAccuracy):
    def __init__(self):
        super().__init__(5)
        self.name = "top5_accuracy"


class BinaryCrossEntropy(Metric):
    name = "binary_crossentropy"

    def update(self, state, y_true, y_pred, weight=None):
        p = y_pred.reshape(y_true.shape).clamp(EPS, 1 - EPS)
        ll = -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))
        return self._accumulate(state, ll, weight)


class CategoricalCrossEntropy(Metric):
    name = "categorical_crossentropy"

    def update(self, state, y_true, y_pred, weight=None):
        ll = -(y_true * torch.log(y_pred.clamp(EPS, 1.0))).sum(-1)
        return self._accumulate(state, ll, weight)


class SparseCategoricalCrossEntropy(Metric):
    name = "sparse_categorical_crossentropy"

    def update(self, state, y_true, y_pred, weight=None):
        p = y_pred.clamp(EPS, 1.0)
        idx = y_true.reshape(p.shape[:-1]).long()
        ll = -torch.log(p.gather(-1, idx[..., None]))[..., 0]
        return self._accumulate(state, ll, weight)


class KLDivergence(Metric):
    name = "kld"

    def update(self, state, y_true, y_pred, weight=None):
        t = y_true.clamp(EPS, 1.0)
        p = y_pred.clamp(EPS, 1.0)
        return self._accumulate(state, (t * torch.log(t / p)).sum(-1),
                                weight)


class Poisson(Metric):
    name = "poisson"

    def update(self, state, y_true, y_pred, weight=None):
        p = y_pred.reshape(y_true.shape)
        return self._accumulate(state, p - y_true * torch.log(p + EPS),
                                weight)


class AUC(Metric):
    """Streaming ROC-AUC from confusion counts at ``thresholds`` fixed
    thresholds (state O(thresholds))."""

    def __init__(self, thresholds: int = 200):
        self.n = thresholds
        self.name = "auc"

    def init_state(self, device=None):
        z = torch.zeros(self.n, device=device)
        return {"tp": z, "fp": z.clone(), "tn": z.clone(), "fn": z.clone()}

    def update(self, state, y_true, y_pred, weight=None):
        y_pred = y_pred.reshape(-1)
        pos = y_true.reshape(-1).float()[None, :]
        w = (torch.ones_like(y_pred) if weight is None
             else weight.reshape(-1))[None, :]
        thr = torch.linspace(0.0, 1.0, self.n, device=y_pred.device)[:, None]
        pred_pos = (y_pred[None, :] >= thr).float()
        return {
            "tp": state["tp"] + (pred_pos * pos * w).sum(-1),
            "fp": state["fp"] + (pred_pos * (1 - pos) * w).sum(-1),
            "fn": state["fn"] + ((1 - pred_pos) * pos * w).sum(-1),
            "tn": state["tn"] + ((1 - pred_pos) * (1 - pos) * w).sum(-1),
        }

    def compute(self, state):
        tpr = state["tp"] / (state["tp"] + state["fn"]).clamp_min(EPS)
        fpr = state["fp"] / (state["fp"] + state["tn"]).clamp_min(EPS)
        return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()


_ALIASES = {
    "accuracy": Accuracy, "acc": Accuracy, "mae": MAE, "mse": MSE,
    "rmse": RMSE, "auc": AUC, "top5accuracy": Top5Accuracy,
    "top5": Top5Accuracy, "binary_accuracy": BinaryAccuracy,
    "categorical_accuracy": CategoricalAccuracy,
    "sparse_categorical_accuracy": SparseCategoricalAccuracy,
    "binary_crossentropy": BinaryCrossEntropy,
    "categorical_crossentropy": CategoricalCrossEntropy,
    "sparse_categorical_crossentropy": SparseCategoricalCrossEntropy,
    "kld": KLDivergence, "poisson": Poisson,
}


def convert_metric(m) -> Metric:
    """str | Metric -> Metric."""
    if isinstance(m, Metric):
        return m
    if isinstance(m, str):
        key = m.lower()
        if key not in _ALIASES:
            raise ValueError(f"unknown metric '{m}'; known: "
                             f"{sorted(_ALIASES)}")
        return _ALIASES[key]()
    raise ValueError(f"cannot convert {m!r} to a Metric")


def convert_metrics_list(metrics) -> Dict[str, Metric]:
    if metrics is None:
        return {}
    if isinstance(metrics, (str, Metric)):
        metrics = [metrics]
    if isinstance(metrics, dict):
        return {name: convert_metric(m) for name, m in metrics.items()}
    out = {}
    for m in metrics:
        mm = convert_metric(m)
        out[mm.name] = mm
    return out

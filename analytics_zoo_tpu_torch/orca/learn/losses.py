"""Loss functions (counterpart of ``analytics_zoo_tpu/orca/learn/losses.py``):
the Keras loss names, each ``(y_true, y_pred) -> per-example loss``; the
train step reduces them, so sample-weight masking composes. Crossentropies
take ``from_logits=False`` by default, the Keras convention: the model then
outputs probabilities."""

from __future__ import annotations

from typing import Callable

import torch

EPS = 1e-7


def _per_example(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(-1)


def mean_squared_error(y_true, y_pred):
    d = y_pred.reshape(y_true.shape) - y_true
    return _per_example(d * d)


def mean_absolute_error(y_true, y_pred):
    return _per_example((y_pred.reshape(y_true.shape) - y_true).abs())


def binary_crossentropy(y_true, y_pred, from_logits: bool = False):
    y_pred = y_pred.reshape(y_true.shape)
    if from_logits:
        ll = (y_pred.clamp_min(0) - y_pred * y_true
              + torch.log1p(torch.exp(-y_pred.abs())))
    else:
        p = y_pred.clamp(EPS, 1 - EPS)
        ll = -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))
    return _per_example(ll)


def _log_probs(y_pred, from_logits):
    if from_logits:
        return torch.log_softmax(y_pred, -1)
    return torch.log(y_pred.clamp(EPS, 1.0))


def categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    return -(y_true * _log_probs(y_pred, from_logits)).sum(-1)


def sparse_categorical_crossentropy(y_true, y_pred, from_logits: bool = False):
    logp = _log_probs(y_pred, from_logits)
    idx = y_true.reshape(logp.shape[:-1]).long()
    return -logp.gather(-1, idx[..., None])[..., 0]


def hinge(y_true, y_pred):
    return _per_example((1.0 - y_true * y_pred.reshape(y_true.shape))
                        .clamp_min(0.0))


def huber(y_true, y_pred, delta: float = 1.0):
    d = (y_pred.reshape(y_true.shape) - y_true).abs()
    return _per_example(torch.where(d <= delta, 0.5 * d * d,
                                    delta * (d - 0.5 * delta)))


def kld(y_true, y_pred):
    t = y_true.clamp(EPS, 1.0)
    p = y_pred.clamp(EPS, 1.0)
    return (t * torch.log(t / p)).sum(-1)


_LOSSES = {
    "mse": mean_squared_error, "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error, "mean_absolute_error": mean_absolute_error,
    "binary_crossentropy": binary_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "hinge": hinge, "huber": huber, "kld": kld,
}


def convert_loss(loss) -> Callable:
    if callable(loss):
        return loss
    if isinstance(loss, str) and loss.lower() in _LOSSES:
        return _LOSSES[loss.lower()]
    raise ValueError(f"unknown loss {loss!r}; known: {sorted(_LOSSES)}")

"""The Keras API's activation names (counterpart of ``analytics_zoo_tpu/
pipeline/api/keras/activations.py``), over torch.

Each entry computes what the JAX package's ``jax.nn`` function computes,
where torch's own default differs:

* ``gelu`` is ``jax.nn.gelu``'s default, the tanh approximation;
* ``hard_sigmoid`` is ``clip(0.2 x + 0.5, 0, 1)`` (torch's is x/6 + 1/2);
* ``softsign``, ``selu`` and ``log_softmax`` are written out as JAX
  writes them; ``softplus`` is ``logaddexp(x, 0)``, which torch's
  ``F.softplus`` cuts over to ``x`` above 20.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

# jax.nn.selu's constants
_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def linear(x):
    return x


def hard_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def softsign(x):
    return x / (x.abs() + 1)


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def selu(x):
    return _SELU_SCALE * torch.where(x > 0, x, _SELU_ALPHA * torch.expm1(x))


def gelu(x):
    return F.gelu(x, approximate="tanh")


def softmax(x):
    return torch.softmax(x, dim=-1)


def log_softmax(x):
    shifted = x - x.amax(dim=-1, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(-1, keepdim=True))


_ACTIVATIONS = {
    "linear": linear,
    "relu": F.relu,
    "relu6": F.relu6,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": hard_sigmoid,
    "tanh": torch.tanh,
    "softmax": softmax,
    "softplus": softplus,
    "softsign": softsign,
    "elu": F.elu,
    "selu": selu,
    "gelu": gelu,
    "swish": F.silu,
    "silu": F.silu,
    "log_softmax": log_softmax,
    "exp": torch.exp,
}


def get(activation: Optional[Union[str, Callable]]) -> Callable:
    if activation is None:
        return linear
    if callable(activation):
        return activation
    try:
        return _ACTIVATIONS[activation.lower()]
    except KeyError:
        raise ValueError(f"unknown activation {activation!r}; "
                         f"available: {sorted(_ACTIVATIONS)}")

"""Symbolic autograd API (counterpart of ``analytics_zoo_tpu/pipeline/api/
autograd.py``): each op is a torch function recorded on the Variable DAG
of ``keras/engine/graph.py`` when given a Variable and applied at once
when given tensors, so a ``CustomLoss`` or ``Lambda`` runs inside the same
forward as the rest of the model."""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ...models.common.initializers import lecun_normal_
from .keras.engine.graph import Variable, has_variable

__all__ = [
    "Variable", "Parameter", "Lambda", "CustomLoss",
    "abs", "sum", "mean", "clip", "square", "sqrt", "exp", "log", "pow",
    "maximum", "minimum", "max", "min", "neg", "softsign", "softplus",
    "mm", "dot", "l2_normalize", "batch_dot", "stack", "expand_dims",
    "contiguous", "mul", "add", "sub", "div", "epsilon", "squeeze",
]


def _unary(fn: Callable, name: str):
    def op(x, *args, **kwargs):
        if isinstance(x, Variable):
            return Variable(op=lambda a: fn(a, *args, **kwargs),
                            parents=[x], name=name)
        return fn(x, *args, **kwargs)
    op.__name__ = name
    return op


def _binary(fn: Callable, name: str):
    def op(x, y):
        xv, yv = isinstance(x, Variable), isinstance(y, Variable)
        if xv and yv:
            return Variable(op=fn, parents=[x, y], name=name)
        if xv:
            return Variable(op=lambda a: fn(a, y), parents=[x], name=name)
        if yv:
            return Variable(op=lambda b: fn(x, b), parents=[y], name=name)
        return fn(x, y)
    op.__name__ = name
    return op


def epsilon() -> float:
    return 1e-7


def _softsign(a):
    return a / (a.abs() + 1)


def _softplus(a):
    return torch.logaddexp(a, torch.zeros((), dtype=a.dtype,
                                          device=a.device))


abs = _unary(torch.abs, "abs")
square = _unary(torch.square, "square")
sqrt = _unary(torch.sqrt, "sqrt")
exp = _unary(torch.exp, "exp")
log = _unary(torch.log, "log")
neg = _unary(lambda a: -a, "neg")
softsign = _unary(_softsign, "softsign")
softplus = _unary(_softplus, "softplus")
contiguous = _unary(lambda a: a, "contiguous")


def sum(x, axis: int = 0, keepdims: bool = False):
    """Sum over ``axis`` (counting every axis, the batch axis too)."""
    return _unary(lambda a: a.sum(dim=axis, keepdim=keepdims), "sum")(x)


def mean(x, axis: int = 0, keepdims: bool = False):
    return _unary(lambda a: a.mean(dim=axis, keepdim=keepdims), "mean")(x)


def max(x, axis: int = 0, keepdims: bool = False):
    return _unary(lambda a: a.amax(dim=axis, keepdim=keepdims), "max")(x)


def min(x, axis: int = 0, keepdims: bool = False):
    return _unary(lambda a: a.amin(dim=axis, keepdim=keepdims), "min")(x)


def clip(x, min_value: float, max_value: float):
    return _unary(lambda a: torch.clamp(a, min_value, max_value), "clip")(x)


def pow(x, a: float):
    return _unary(lambda v: v ** a, "pow")(x)


def expand_dims(x, axis: int):
    return _unary(lambda a: a.unsqueeze(axis), "expand_dims")(x)


def squeeze(x, axis: Optional[int] = None):
    return _unary(lambda a: a.squeeze() if axis is None else a.squeeze(axis),
                  "squeeze")(x)


def _l2_normalize(a, axis):
    return a / torch.linalg.vector_norm(a, dim=axis,
                                        keepdim=True).clamp_min(1e-12)


def l2_normalize(x, axis: int = -1):
    return _unary(lambda a: _l2_normalize(a, axis), "l2_normalize")(x)


maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
add = _binary(lambda a, b: a + b, "add")
sub = _binary(lambda a, b: a - b, "sub")
mul = _binary(lambda a, b: a * b, "mul")
div = _binary(lambda a, b: a / b, "div")


def _batch_contract(a, b, axes):
    """``lax.dot_general`` with batch axis 0 on both and contracting axis
    ``axes[0]`` of ``a`` with ``axes[1]`` of ``b``: the result holds the
    batch axis, then ``a``'s free axes, then ``b``'s."""
    letters = "abcdefghijklmnopqrstuvwxyz"     # free axes; B batch, Z sum
    ia, ib = axes[0] % a.ndim, axes[1] % b.ndim
    sa = ["B"] + [letters[i] for i in range(a.ndim - 1)]
    sb = ["B"] + [letters[a.ndim - 1 + i] for i in range(b.ndim - 1)]
    sb[ib] = sa[ia] = "Z"
    out = [c for c in sa if c != "Z"] + [c for c in sb[1:] if c != "Z"]
    return torch.einsum(f"{''.join(sa)},{''.join(sb)}->{''.join(out)}",
                        a, b)


def mm(x, y, axes: Optional[Sequence[int]] = None):
    """Batch matrix multiply, optionally contracting ``axes``."""
    def fn(a, b):
        if axes is not None:
            return _batch_contract(a, b, axes)
        return torch.matmul(a, b)
    return _binary(fn, "mm")(x, y)


def batch_dot(x, y, axes: Sequence[int] = (2, 2), normalize: bool = False):
    def fn(a, b):
        if normalize:
            a, b = _l2_normalize(a, axes[0]), _l2_normalize(b, axes[1])
        return _batch_contract(a, b, axes)
    return _binary(fn, "batch_dot")(x, y)


def dot(x, y):
    return mm(x, y)


def stack(inputs: Sequence[Any], axis: int = 1):
    if has_variable(inputs):
        return Variable(op=lambda *xs: torch.stack(xs, dim=axis),
                        parents=list(inputs), name="stack")
    return torch.stack(list(inputs), dim=axis)


class _ParamLeaf(nn.Module):
    """A free parameter ``weight`` of a graph: ``init_weight``, or flax's
    ``lecun_normal`` (fan-in: the product of all axes but the last)."""

    flax_free_params = ("weight",)

    def __init__(self, shape, init_weight=None, trainable: bool = True):
        super().__init__()
        self.trainable = trainable
        if init_weight is not None:
            self.weight = nn.Parameter(torch.as_tensor(
                init_weight, dtype=torch.float32).clone())
        else:
            self.weight = nn.Parameter(torch.empty(tuple(shape)))
            lecun_normal_(self.weight, max(math.prod(shape[:-1]), 1))

    def forward(self):
        return self.weight if self.trainable else self.weight.detach()


class Parameter(Variable):
    """A trainable standalone weight usable in autograd expressions; a
    parameter of the Model whose graph uses it."""

    def __init__(self, shape, init_weight=None, trainable: bool = True,
                 name: Optional[str] = None):
        super().__init__(shape=tuple(shape), name=name or "parameter",
                         op=_ParamLeaf(tuple(shape), init_weight, trainable),
                         parents=[])


class Lambda:
    """Wrap a torch function as a layer / graph node: Variables build a
    node, tensors compute."""

    def __init__(self, function: Callable, input_shape=None, name=None):
        self.function = function
        self.name = name or "lambda"

    def __call__(self, *xs):
        if has_variable(xs):
            return Variable(op=self.function, parents=list(xs),
                            name=self.name)
        return self.function(*xs)


class CustomLoss:
    """A loss from a function of (y_true, y_pred) tensors; the estimator
    takes it wherever it takes a loss."""

    def __init__(self, loss_func: Callable = None, y_pred_shape=None,
                 y_true_shape=None):
        self.loss_func = loss_func

    def __call__(self, y_true, y_pred):
        out = self.loss_func(y_true, y_pred)
        if isinstance(out, Variable):
            raise TypeError("CustomLoss function must operate on tensors; "
                            "got a Variable graph")
        return out

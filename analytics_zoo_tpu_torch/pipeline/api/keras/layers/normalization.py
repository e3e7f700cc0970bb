"""Normalization layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras/layers/normalization.py``).

``BatchNormalization`` holds flax's ``BatchNorm_0``: the ResNet port's
``BatchNorm`` (``models/common/batch_norm.py``), which updates the running
variance with the biased batch variance as flax does, at flax momentum
0.99 (torch's 0.01) and epsilon 1e-3, its width taken from the first
input. The channel axis is 1 for "th" ordering on 4-D inputs, else the
last, unless ``axis`` is given. ``LayerNormalization`` holds
``LayerNorm_0`` (epsilon 1e-6).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from .....models.common.batch_norm import BatchNorm
from .core import Layer


class LazyBatchNorm(LazyModuleMixin, BatchNorm):
    """The ResNet port's ``BatchNorm`` with its width from the first
    input's axis 1 (scale 1, bias 0, running mean 0, variance 1)."""

    cls_to_become = BatchNorm

    def __init__(self, momentum: float, epsilon: float):
        super().__init__(0, momentum=momentum, epsilon=epsilon)
        self.weight = UninitializedParameter()
        self.bias = UninitializedParameter()
        self.running_mean = UninitializedBuffer()
        self.running_var = UninitializedBuffer()

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            c = x.shape[1]
            with torch.no_grad():
                for t, v in ((self.weight, 1.0), (self.bias, 0.0),
                             (self.running_mean, 0.0),
                             (self.running_var, 1.0)):
                    t.materialize((c,))
                    t.fill_(v)


class BatchNormalization(Layer):
    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99,
                 beta_init: str = "zero", gamma_init: str = "one",
                 dim_ordering: str = "th", axis: Optional[int] = None,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dim_ordering, self.axis = dim_ordering, axis
        self.BatchNorm_0 = LazyBatchNorm(momentum, epsilon)

    def forward(self, x):
        if self.axis is not None:
            axis = self.axis
        elif self.dim_ordering == "th" and x.ndim == 4:
            axis = 1
        else:
            axis = -1
        axis %= x.ndim
        if axis == 1:
            return self.BatchNorm_0(x)
        return self.BatchNorm_0(x.movedim(axis, 1)).movedim(1, axis)


class LazyLayerNorm(LazyModuleMixin, nn.Module):
    """flax ``nn.LayerNorm(epsilon)`` over the last axis, its width from
    the first input (scale 1, bias 0)."""

    def __init__(self, epsilon: float):
        super().__init__()
        self.epsilon = epsilon
        self.weight = UninitializedParameter()
        self.bias = UninitializedParameter()

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            with torch.no_grad():
                self.weight.materialize((x.shape[-1],))
                self.bias.materialize((x.shape[-1],))
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias,
                            self.epsilon)


class LayerNormalization(Layer):
    def __init__(self, epsilon: float = 1e-6, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.LayerNorm_0 = LazyLayerNorm(epsilon)

    def forward(self, x):
        return self.LayerNorm_0(x)


class LRN2D(Layer):
    """Local response normalization across channels: x / (k + alpha *
    sum of squares over ``n`` neighbouring channels) ** beta."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5, dim_ordering: str = "th",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n
        self.dim_ordering = dim_ordering

    def forward(self, x):
        ch_axis = 1 if self.dim_ordering == "th" else x.ndim - 1
        xc = x.movedim(ch_axis, -1)
        half = self.n // 2
        padded = F.pad(xc * xc, (half, half))
        acc = torch.zeros_like(xc)
        for i in range(self.n):
            acc = acc + padded[..., i:i + xc.shape[-1]]
        out = xc / torch.pow(self.k + self.alpha * acc, self.beta)
        return out.movedim(-1, ch_axis)


class WithinChannelLRN2D(Layer):
    """Spatial LRN of a channels-first input: x / (1 + alpha / size^2 *
    the size x size window's sum of squares, zero-padded "SAME") ** beta."""

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.size, self.alpha, self.beta = size, alpha, beta

    def forward(self, x):
        win = self.size
        lo, hi = (win - 1) // 2, (win - 1) - (win - 1) // 2
        sq = F.pad(x * x, (lo, hi, lo, hi))
        avg = F.avg_pool2d(sq, win, stride=1)
        return x / torch.pow(1.0 + (self.alpha / (win * win)) * avg,
                             self.beta)

"""Advanced activation layers (counterpart of ``analytics_zoo_tpu/
pipeline/api/keras/layers/advanced_activations.py``). Learned parameters
keep flax's names (``alpha``; ``t_right``, ``a_right``, ``t_left``,
``a_left``); ``RReLU`` draws its training slopes from the engine's
generator."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter

from .core import Layer
from .self_attention import DrawsRandom


class LeakyReLU(Layer):
    def __init__(self, alpha: float = 0.3, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def forward(self, x):
        return F.leaky_relu(x, negative_slope=self.alpha)


class ELU(Layer):
    def __init__(self, alpha: float = 1.0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, alpha=self.alpha)


class PReLU(Layer):
    """Learned slope, shared (``n_output_plane=0``) or one per channel of
    axis 1; starts at 0.25."""

    def __init__(self, n_output_plane: int = 0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.n_output_plane = n_output_plane
        self.alpha = nn.Parameter(torch.full((max(n_output_plane, 1),),
                                             0.25))

    def forward(self, x):
        alpha = self.alpha
        if self.n_output_plane != 0:
            shape = [1] * x.ndim
            shape[1] = self.n_output_plane
            alpha = alpha.reshape(shape)
        return torch.where(x >= 0, x, alpha * x)


class ThresholdedReLU(Layer):
    def __init__(self, theta: float = 1.0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.theta = theta

    def forward(self, x):
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class SReLU(LazyModuleMixin, Layer):
    """S-shaped ReLU with four learned parameters per feature of the last
    axis (t_right 1, a_right 0.2, t_left 0, a_left 0.2)."""

    _INIT = (("t_right", 1.0), ("a_right", 0.2), ("t_left", 0.0),
             ("a_left", 0.2))

    def __init__(self, input_shape: Any = None,
                 shared_axes: Optional[Tuple[int, ...]] = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.shared_axes = shared_axes
        for pname, _ in self._INIT:
            setattr(self, pname, UninitializedParameter())

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            with torch.no_grad():
                for pname, v in self._INIT:
                    p = getattr(self, pname)
                    p.materialize((x.shape[-1],))
                    p.fill_(v)

    def forward(self, x):
        t_r, a_r = self.t_right, self.a_right
        t_l, a_l = self.t_left, self.a_left
        above = torch.where(x >= t_r, t_r + a_r * (x - t_r), x)
        return torch.where(x <= t_l, t_l + a_l * (x - t_l), above)


class RReLU(DrawsRandom, Layer):
    """Randomized leaky ReLU: slopes uniform in [lower, upper] per element
    in training, their mean in evaluation."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.lower, self.upper = lower, upper

    def forward(self, x):
        if self.training:
            a = torch.empty_like(x).uniform_(self.lower, self.upper,
                                             generator=self.generator)
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(x >= 0, x, a * x)

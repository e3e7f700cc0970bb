"""Noise layers (counterpart of ``analytics_zoo_tpu/pipeline/api/keras/
layers/noise.py``): active in training only, drawing from the generator
the training engine hands every ``DrawsRandom`` layer."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .core import Layer
from .self_attention import DrawsRandom


class GaussianNoise(DrawsRandom, Layer):
    """x + sigma * N(0, 1)"""

    def __init__(self, sigma: float = 0.1, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.sigma = sigma

    def forward(self, x):
        if not self.training:
            return x
        noise = torch.randn(x.shape, generator=self.generator,
                            device=x.device, dtype=x.dtype)
        return x + self.sigma * noise


class GaussianDropout(DrawsRandom, Layer):
    """x * (1 + sqrt(p / (1 - p)) * N(0, 1))"""

    def __init__(self, p: float = 0.5, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.p = p

    def forward(self, x):
        if not self.training or self.p <= 0:
            return x
        stddev = (self.p / (1.0 - self.p)) ** 0.5
        noise = torch.randn(x.shape, generator=self.generator,
                            device=x.device, dtype=x.dtype)
        return x * (1.0 + stddev * noise)


class _SpatialDropout(DrawsRandom, Layer):
    """Drops whole feature maps: one keep draw per (sample, channel),
    broadcast over the ``broadcast_axes``; kept maps scale by 1 / (1 - p)."""

    def __init__(self, p: float = 0.5, dim_ordering: str = "th",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.p, self.dim_ordering = p, dim_ordering

    def broadcast_axes(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def forward(self, x):
        if not self.training or self.p <= 0:
            return x
        keep = 1.0 - self.p
        axes = self.broadcast_axes()
        shape = [1 if i in axes else n for i, n in enumerate(x.shape)]
        mask = torch.empty(shape, device=x.device, dtype=x.dtype)
        mask.bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class SpatialDropout1D(_SpatialDropout):
    """Input (batch, steps, channels)."""

    def __init__(self, p: float = 0.5, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(p, "th", input_shape, name)

    def broadcast_axes(self):
        return (1,)


class SpatialDropout2D(_SpatialDropout):
    def broadcast_axes(self):
        return (2, 3) if self.dim_ordering == "th" else (1, 2)


class SpatialDropout3D(_SpatialDropout):
    def broadcast_axes(self):
        return (2, 3, 4) if self.dim_ordering == "th" else (1, 2, 3)

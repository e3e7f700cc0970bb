"""flax's ``nn.BatchNorm`` for the port's modules: the ResNet port's
BatchNorm layers and the Keras ``BatchNormalization``.

It normalises with f32 batch statistics (training) or the running ones
(evaluation) and writes its output in the input's dtype; a train step
updates ``running_mean`` and ``running_var`` towards the batch mean and the
*biased* batch variance, as flax does (``torch.nn.BatchNorm2d`` takes the
unbiased one, and counts batches; this one does not).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# flax nn.BatchNorm as the JAX ResNet builds it
BN_MOMENTUM = 0.9
BN_EPSILON = 1e-5


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype=...)`` over axis 1 of
    its input; ``momentum`` in flax's sense, running = m * running + (1 -
    m) * batch, the JAX ResNet's by default. The output keeps the input's
    dtype, which is flax's ``dtype`` in the ResNet: the convs before it
    already write ``compute_dtype``."""

    def __init__(self, features: int, scale_init: float = 1.0,
                 momentum: float = BN_MOMENTUM, epsilon: float = BN_EPSILON):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.weight = nn.Parameter(torch.full((features,), float(scale_init)))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.epsilon)
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.epsilon)
        with torch.no_grad():
            # the biased batch variance, from the 1/sqrt(var + eps) the
            # normalisation used (f32)
            var = invstd.float().reciprocal().square_().sub_(self.epsilon)
            m = self.momentum
            self.running_mean.mul_(m).add_(mean.float(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.clamp_min_(0.0),
                                          alpha=1.0 - m)
        return y

"""Core Keras layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras/layers/core.py``) as ``torch.nn`` modules.

Each layer computes what the flax layer computes, and its submodules and
parameters carry flax's names (a ``Dense`` holds its ``nn.Linear`` as
``Dense_0``; ``Highway`` holds ``Dense_0`` and ``Dense_1``; ``Scale`` has
``weight`` and ``bias``), so ``interop`` maps the two packages' weights
by name.

Input widths: flax infers a ``Dense``'s input width at init from a sample
input. Here the widths that depend on the input are torch lazy parameters,
materialised by the first forward (the estimator runs one sample row
through a module that still has some before it builds the optimizer, as
flax's init does) or by loading a state dict.

Initialisers are flax's: ``Dense`` ``glorot_uniform`` (``xavier_uniform_``
on the ``(out, in)`` weight) or else ``lecun_normal``, the inner Dense of
``Highway`` and ``MaxoutDense`` ``lecun_normal``, biases zero; draws come
from torch's global generator.

Layers that draw random numbers in training (``Dropout``,
``GaussianSampler``) draw from the generator the training engine hands
them (``self_attention.DrawsRandom``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter

from .....models.common.initializers import lecun_normal_
from .. import activations
from .self_attention import DrawsRandom
from .self_attention import Dropout as _Dropout


class Layer(nn.Module):
    """Base of the Keras layers: ``input_shape`` is accepted as in the
    reference (widths come from the input), ``name`` names the node in a
    functional graph."""

    def __init__(self, input_shape: Any = None, name: Optional[str] = None):
        super().__init__()
        self.input_shape = input_shape
        self.name = name


class FlaxLinear(nn.LazyLinear):
    """``nn.Linear`` with a lazy input width, initialised as flax's
    ``nn.Dense(kernel_init=...)``: ``"glorot_uniform"`` or
    ``"lecun_normal"``, zero bias. It becomes a plain ``nn.Linear`` once
    its width is known."""

    cls_to_become = nn.Linear

    def __init__(self, out_features: int, bias: bool = True,
                 kernel_init: str = "lecun_normal"):
        super().__init__(out_features, bias)
        self.kernel_init = kernel_init

    def reset_parameters(self) -> None:
        if self.has_uninitialized_params() or self.in_features == 0:
            return
        with torch.no_grad():
            if self.kernel_init == "glorot_uniform":
                nn.init.xavier_uniform_(self.weight)
            else:
                lecun_normal_(self.weight, self.in_features)
            if self.bias is not None:
                self.bias.zero_()


class Dense(Layer):
    def __init__(self, output_dim: int,
                 activation: Optional[Union[str, Callable]] = None,
                 use_bias: bool = True, init_method: str = "glorot_uniform",
                 W_regularizer: Any = None, b_regularizer: Any = None,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.output_dim, self.activation = output_dim, activation
        kernel_init = ("glorot_uniform" if init_method == "glorot_uniform"
                       else "lecun_normal")
        self.Dense_0 = FlaxLinear(output_dim, use_bias, kernel_init)

    def forward(self, x):
        return activations.get(self.activation)(self.Dense_0(x))


class SparseDense(Dense):
    """Dense math, as in the JAX package."""


class Activation(Layer):
    def __init__(self, activation: Union[str, Callable] = "relu",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.activation = activation

    def forward(self, x):
        return activations.get(self.activation)(x)


class Dropout(_Dropout):
    """Drops a fraction ``p`` of the inputs in training (the port's
    ``Dropout``, so the engine hands it its generator)."""

    def __init__(self, p: float = 0.5, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(p)
        self.input_shape, self.name = input_shape, name


class Flatten(Layer):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Reshape(Layer):
    """target_shape may contain one -1 (inferred), like the reference."""

    def __init__(self, target_shape: Tuple[int, ...] = (),
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.target_shape = tuple(target_shape)

    def forward(self, x):
        return x.reshape((x.shape[0],) + self.target_shape)


class Permute(Layer):
    """dims are 1-indexed over non-batch axes, matching the reference."""

    def __init__(self, dims: Tuple[int, ...] = (), input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dims = tuple(dims)

    def forward(self, x):
        return x.permute((0,) + self.dims)


class RepeatVector(Layer):
    def __init__(self, n: int = 1, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.n = n

    def forward(self, x):
        return x[:, None, :].repeat(1, self.n, 1)


class Masking(Layer):
    """Zeroes the timesteps equal to mask_value everywhere."""

    def __init__(self, mask_value: float = 0.0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.mask_value = mask_value

    def forward(self, x):
        keep = (x != self.mask_value).any(dim=-1, keepdim=True)
        return x * keep.to(x.dtype)


class Highway(Layer):
    """y = t * h(W_h x) + (1 - t) * x with t = sigmoid(W_t x)."""

    def __init__(self, activation: Optional[Union[str, Callable]] = None,
                 use_bias: bool = True, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.activation = activation
        # both maps are square: their width is the input's
        self.Dense_0 = FlaxLinear(0, use_bias)
        self.Dense_1 = FlaxLinear(0, use_bias)

    def forward(self, x):
        for d in (self.Dense_0, self.Dense_1):
            if d.out_features == 0:
                d.out_features = x.shape[-1]
        h = activations.get(self.activation)(self.Dense_0(x))
        t = torch.sigmoid(self.Dense_1(x))
        return t * h + (1.0 - t) * x


class MaxoutDense(Layer):
    """Max over ``nb_feature`` linear maps."""

    def __init__(self, output_dim: int = 1, nb_feature: int = 4,
                 use_bias: bool = True, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.output_dim, self.nb_feature = output_dim, nb_feature
        self.Dense_0 = FlaxLinear(output_dim * nb_feature, use_bias)

    def forward(self, x):
        y = self.Dense_0(x)
        y = y.reshape(y.shape[:-1] + (self.nb_feature, self.output_dim))
        return y.amax(dim=-2)


class _Elementwise(Layer):
    def fn(self, x):
        raise NotImplementedError

    def forward(self, x):
        return self.fn(x)


class Exp(_Elementwise):
    def fn(self, x):
        return torch.exp(x)


class Log(_Elementwise):
    def fn(self, x):
        return torch.log(x)


class Sqrt(_Elementwise):
    def fn(self, x):
        return torch.sqrt(x)


class Square(_Elementwise):
    def fn(self, x):
        return torch.square(x)


class Negative(_Elementwise):
    def fn(self, x):
        return -x


class Identity(_Elementwise):
    def fn(self, x):
        return x


class AddConstant(Layer):
    def __init__(self, constant: float = 0.0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.constant = constant

    def forward(self, x):
        return x + self.constant


class MulConstant(Layer):
    def __init__(self, constant: float = 1.0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.constant = constant

    def forward(self, x):
        return x * self.constant


class Power(Layer):
    """(shift + scale * x) ** power"""

    def __init__(self, power: float = 1.0, scale: float = 1.0,
                 shift: float = 0.0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x):
        return (self.shift + self.scale * x) ** self.power


class Scale(LazyModuleMixin, Layer):
    """Learned per-feature affine x * weight + bias along ``axis``; both
    are shaped like the input with every other axis 1, and their size
    comes from the first input."""

    flax_free_params = ("weight", "bias")

    def __init__(self, axis: int = -1, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.axis = axis
        self.weight = UninitializedParameter()
        self.bias = UninitializedParameter()

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            shape = [1] * x.ndim
            shape[self.axis] = x.shape[self.axis]
            with torch.no_grad():
                self.weight.materialize(tuple(shape))
                self.bias.materialize(tuple(shape))
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        return x * self.weight + self.bias


class CAdd(Layer):
    """Learned additive bias of a given broadcast shape."""

    def __init__(self, size: Tuple[int, ...] = (), input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.size = tuple(size)
        self.bias = nn.Parameter(torch.zeros(self.size))

    def forward(self, x):
        return x + self.bias


class CMul(Layer):
    flax_free_params = ("weight",)

    def __init__(self, size: Tuple[int, ...] = (), input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.size = tuple(size)
        self.weight = nn.Parameter(torch.ones(self.size))

    def forward(self, x):
        return x * self.weight


class Mul(Layer):
    """A single learned scalar multiplier."""

    flax_free_params = ("weight",)

    def __init__(self, input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.weight = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.weight


class Select(Layer):
    """Element ``index`` of axis ``dim`` (dim counts every axis), the axis
    dropped."""

    def __init__(self, dim: int = 1, index: int = 0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dim, self.index = dim, index

    def forward(self, x):
        return x.select(self.dim, self.index)


class Squeeze(Layer):
    def __init__(self, dim: Optional[Union[int, Tuple[int, ...]]] = None,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dim = dim

    def forward(self, x):
        return x.squeeze() if self.dim is None else x.squeeze(self.dim)


class ExpandDim(Layer):
    def __init__(self, dim: int = 0, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dim = dim

    def forward(self, x):
        return x.unsqueeze(self.dim)


class Narrow(Layer):
    """``length`` elements from ``offset`` along ``dim``."""

    def __init__(self, dim: int = 1, offset: int = 0, length: int = 1,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x):
        return x.narrow(self.dim, self.offset, self.length)


class GetShape(Layer):
    def forward(self, x):
        return torch.tensor(x.shape, device=x.device)


class Threshold(Layer):
    """x if x > th else v"""

    def __init__(self, th: float = 1e-6, v: float = 0.0,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.th, self.v = th, v

    def forward(self, x):
        return torch.where(x > self.th, x, torch.full_like(x, self.v))


class BinaryThreshold(Layer):
    def __init__(self, value: float = 1e-6, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.value = value

    def forward(self, x):
        return (x > self.value).to(torch.float32)


class HardTanh(Layer):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)


class HardShrink(Layer):
    def __init__(self, value: float = 0.5, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.value = value

    def forward(self, x):
        return torch.where(x.abs() > self.value, x, torch.zeros_like(x))


class SoftShrink(Layer):
    def __init__(self, value: float = 0.5, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.value = value

    def forward(self, x):
        return torch.sign(x) * (x.abs() - self.value).clamp_min(0.0)


class GaussianSampler(DrawsRandom, Layer):
    """VAE reparameterisation: a pair [mean, log_var] -> mean +
    exp(log_var / 2) * N(0, 1) in training, the mean in evaluation."""

    def forward(self, mean_logvar):
        mean, log_var = mean_logvar
        if not self.training:
            return mean
        eps = torch.randn(mean.shape, generator=self.generator,
                          device=mean.device, dtype=mean.dtype)
        return mean + torch.exp(0.5 * log_var) * eps


class Merge(Layer):
    """Merge a list of inputs: mode in sum/mul/concat/ave/max/min/dot/cos."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.mode, self.concat_axis = mode, concat_axis

    def forward(self, *xs):
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
            xs = tuple(xs[0])
        m = self.mode
        if m == "concat":
            return torch.cat(xs, dim=self.concat_axis)
        if m == "sum":
            out = xs[0]
            for x in xs[1:]:
                out = out + x
            return out
        if m == "mul":
            out = xs[0]
            for x in xs[1:]:
                out = out * x
            return out
        if m == "ave":
            return sum(xs) / len(xs)
        if m == "max":
            out = xs[0]
            for x in xs[1:]:
                out = torch.maximum(out, x)
            return out
        if m == "min":
            out = xs[0]
            for x in xs[1:]:
                out = torch.minimum(out, x)
            return out
        if m == "dot":
            a, b = xs
            return (a * b).sum(-1, keepdim=True)
        if m == "cos":
            a, b = xs
            num = (a * b).sum(-1, keepdim=True)
            den = (torch.linalg.vector_norm(a, dim=-1, keepdim=True) *
                   torch.linalg.vector_norm(b, dim=-1, keepdim=True))
            return num / den.clamp_min(1e-8)
        raise ValueError(f"unknown merge mode {m!r}")


def merge(inputs: Sequence[Any], mode: str = "sum", concat_axis: int = -1,
          name: Optional[str] = None):
    """Functional merge over symbolic Variables or tensors."""
    return Merge(mode=mode, concat_axis=concat_axis, name=name)(*inputs)


class ResizeBilinear(Layer):
    """Bilinear resize to (output_height, output_width) with half-pixel
    centres and, when shrinking, a triangle filter widened by the scale
    (``jax.image.resize(method="bilinear")``, whose antialiasing is on).
    ``align_corners`` is accepted and ignored, as in the JAX package."""

    def __init__(self, output_height: int = 0, output_width: int = 0,
                 align_corners: bool = False,
                 data_format: str = "channels_last",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.output_height, self.output_width = output_height, output_width
        self.align_corners, self.data_format = align_corners, data_format

    def forward(self, x):
        if self.data_format != "channels_first":
            x = x.permute(0, 3, 1, 2)
        out = F.interpolate(x, size=(self.output_height, self.output_width),
                            mode="bilinear", align_corners=False,
                            antialias=True)
        if self.data_format != "channels_first":
            out = out.permute(0, 2, 3, 1)
        return out


__all__ = ["Activation", "AddConstant", "BinaryThreshold", "CAdd", "CMul",
           "Dense", "Dropout", "Exp", "ExpandDim", "Flatten",
           "GaussianSampler", "GetShape", "HardShrink", "HardTanh",
           "Highway", "Identity", "Log", "Masking", "MaxoutDense", "Merge",
           "Mul", "MulConstant", "Narrow", "Negative", "Permute", "Power",
           "RepeatVector", "Reshape", "ResizeBilinear", "Scale", "Select",
           "SoftShrink", "SparseDense", "Sqrt", "Square", "Squeeze",
           "Threshold", "merge"]


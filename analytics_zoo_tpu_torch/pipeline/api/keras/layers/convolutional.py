"""Convolution, padding, cropping and upsampling layers (counterpart of
``analytics_zoo_tpu/pipeline/api/keras/layers/convolutional.py``).

Layouts: the 1-D layers take ``(batch, steps, dim)``; the 2-D and 3-D
layers take channels-first input for ``dim_ordering="th"`` (the default)
and channels-last for ``"tf"``, as in the JAX package. Inside, torch's
convolutions run channels-first (the JAX package runs channels-last: the
two are one function).

Parameters carry flax's names: a convolution layer holds ``Conv_0``
(``SeparableConvolution2D`` ``Conv_0`` and ``Conv_1``,
``Deconvolution2D`` ``ConvTranspose_0``), whose ``weight`` is the flax
kernel ``(*k, in, out)`` as ``(out, in, *k)``; ``LocallyConnected1D``/
``2D`` hold ``weight`` and ``bias`` themselves, the weight the flax kernel
``(L, in, out)`` / ``(oh, ow, in, out)`` as ``(out, in, L)`` / ``(out,
in, oh, ow)``, which is how ``interop`` transposes a kernel of that rank.

Padding is flax's, written out: VALID pads nothing; SAME pads ``total =
max((ceil(n / s) - 1) s + (k - 1) d + 1 - n, 0)``, ``total // 2`` at the
start and the rest at the end, so a stride above 1 pads more at the end
than at the start (torch's ``padding="same"`` refuses strides).

``Deconvolution2D`` is flax's ``nn.ConvTranspose`` (``transpose_kernel``
False): a correlation of the stride-dilated input with the kernel as it
is, padded by ``lax.conv_transpose``'s rule. ``F.conv_transpose2d`` with
the kernel flipped spatially and its in and out axes swapped gives the
full correlation, which is then cropped (or zero-padded) to flax's
padding before the bias is added.

Init as the JAX code draws, not as the ``init_method`` field says: every
``nn.Conv`` there takes flax's default ``lecun_normal`` (fan_in ``prod(k)
* in / groups``), biases zero; ``LocallyConnected*`` draw
``glorot_uniform`` over their kernel's last two axes.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin
from torch.nn.parameter import UninitializedParameter

from .....models.common.initializers import lecun_normal_
from .. import activations
from .core import Layer

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _pad_mode(border_mode: str) -> str:
    return {"same": "SAME", "valid": "VALID"}[border_mode]


def same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """flax's (lax's) SAME padding of one axis: ``(start, end)``."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _torch_pads(pads: Sequence[Tuple[int, int]]):
    """``[(start, end)]`` per spatial axis -> ``F.pad``'s flat list (last
    axis first)."""
    return [p for pair in reversed(list(pads)) for p in pair]


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class FlaxConv(LazyModuleMixin, nn.Module):
    """flax's ``nn.Conv`` on channels-first input ``(N, C, *spatial)``:
    ``weight (out, in / groups, *k)``, ``lecun_normal``, zero bias; the
    input width waits for the first input unless ``in_features`` is
    given. ``depth_multiplier`` makes it depthwise (flax's
    ``feature_group_count`` = the input width, ``features`` = the width
    times the multiplier); the group count is read off the weight's
    shape, so a loaded weight sizes it too."""

    def __init__(self, features: Optional[int],
                 kernel_size: Sequence[int],
                 strides: Optional[Sequence[int]] = None,
                 padding: str = "SAME",
                 dilation: Optional[Sequence[int]] = None,
                 use_bias: bool = True, in_features: Optional[int] = None,
                 depth_multiplier: Optional[int] = None):
        super().__init__()
        self.features, self.depth_multiplier = features, depth_multiplier
        self.kernel_size = tuple(kernel_size)
        n = len(self.kernel_size)
        self.strides = _tup(strides or 1, n)
        self.dilation = _tup(dilation or 1, n)
        self.padding = padding
        self.weight = UninitializedParameter()
        if use_bias:
            self.bias = UninitializedParameter()
        else:
            self.register_parameter("bias", None)
        if in_features is not None:
            self._init(in_features)

    def _init(self, in_features: int):
        if self.depth_multiplier:
            out, per_group = in_features * self.depth_multiplier, 1
        else:
            out, per_group = self.features, in_features
        with torch.no_grad():
            self.weight.materialize((out, per_group) + self.kernel_size)
            lecun_normal_(self.weight, per_group * math.prod(self.kernel_size))
            if self.bias is not None:
                self.bias.materialize((out,))
                self.bias.zero_()

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            self._init(x.shape[1])

    def forward(self, x):
        n = len(self.kernel_size)
        if self.padding == "SAME":
            pads = [same_pads(x.shape[2 + i], self.kernel_size[i],
                              self.strides[i], self.dilation[i])
                    for i in range(n)]
            x = F.pad(x, _torch_pads(pads))
        return _CONV[n](x, self.weight, self.bias, self.strides, 0,
                        self.dilation, x.shape[1] // self.weight.shape[1])


def conv_transpose_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    if padding == "SAME":
        total = k + s - 2
        start = k - 1 if s > k - 1 else -(-total // 2)
    else:
        total = k + s - 2 + max(k - s, 0)
        start = k - 1
    return start, total - start


class FlaxConvTranspose(LazyModuleMixin, nn.Module):
    """flax's ``nn.ConvTranspose`` (2-D, ``transpose_kernel`` False) on
    channels-first input; ``weight (out, in, kh, kw)`` is the flax kernel
    ``(kh, kw, in, out)`` as a convolution's."""

    def __init__(self, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 use_bias: bool = True):
        super().__init__()
        self.features = features
        self.kernel_size, self.strides = tuple(kernel_size), tuple(strides)
        self.padding = padding
        self.weight = UninitializedParameter()
        if use_bias:
            self.bias = UninitializedParameter()
        else:
            self.register_parameter("bias", None)

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            with torch.no_grad():
                self.weight.materialize((self.features, x.shape[1])
                                        + self.kernel_size)
                lecun_normal_(self.weight,
                              x.shape[1] * math.prod(self.kernel_size))
                if self.bias is not None:
                    self.bias.materialize((self.features,))
                    self.bias.zero_()

    def forward(self, x):
        # the full correlation of the dilated input (padded by k - 1 on
        # each side) with the unflipped kernel ...
        w = self.weight.flip(2, 3).transpose(0, 1)
        y = F.conv_transpose2d(x, w, None, self.strides)
        # ... cut (or zero-padded) to flax's padding
        pads = []
        for k, s in zip(self.kernel_size, self.strides):
            start, end = conv_transpose_pads(k, s, self.padding)
            pads.append((start - (k - 1), end - (k - 1)))
        y = F.pad(y, _torch_pads(pads))
        return y if self.bias is None else y + self.bias.view(-1, 1, 1)


def _channels_first(x, dim_ordering):
    return x if dim_ordering == "th" else x.movedim(-1, 1)


def _channels_back(x, dim_ordering):
    return x if dim_ordering == "th" else x.movedim(1, -1)


class _ConvND(Layer):
    """A convolution layer over ``Conv_0``; ``n`` spatial axes."""

    def __init__(self, n: int, nb_filter, kernel, strides, dilation,
                 border_mode, activation, dim_ordering, use_bias,
                 input_shape, name):
        super().__init__(input_shape, name)
        self.n, self.activation = n, activation
        self.dim_ordering = dim_ordering
        self.nb_filter, self.border_mode = nb_filter, border_mode
        self.use_bias = use_bias
        self.Conv_0 = FlaxConv(nb_filter, kernel, strides,
                               _pad_mode(border_mode), dilation,
                               use_bias=use_bias)

    def forward(self, x):
        if self.n == 1:                     # (b, steps, dim)
            return activations.get(self.activation)(
                self.Conv_0(x.transpose(1, 2)).transpose(1, 2))
        y = self.Conv_0(_channels_first(x, self.dim_ordering))
        return _channels_back(activations.get(self.activation)(y),
                              self.dim_ordering)


class Convolution1D(_ConvND):
    """Input ``(batch, steps, dim)``."""

    def __init__(self, nb_filter: int = 1, filter_length: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 dilation_rate: int = 1, use_bias: bool = True,
                 init_method: str = "glorot_uniform",
                 W_regularizer: Any = None, b_regularizer: Any = None,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(1, nb_filter, (filter_length,), (subsample_length,),
                         (dilation_rate,), border_mode, activation, None,
                         use_bias, input_shape, name)
        self.filter_length, self.subsample_length = (filter_length,
                                                     subsample_length)
        self.dilation_rate, self.init_method = dilation_rate, init_method
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer


class AtrousConvolution1D(Convolution1D):
    """Dilated by ``atrous_rate`` (``dilation_rate`` is unused, as in the
    JAX package)."""

    def __init__(self, nb_filter: int = 1, filter_length: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid", subsample_length: int = 1,
                 dilation_rate: int = 1, use_bias: bool = True,
                 init_method: str = "glorot_uniform",
                 W_regularizer: Any = None, b_regularizer: Any = None,
                 input_shape: Any = None, atrous_rate: int = 1,
                 name: Optional[str] = None):
        super().__init__(nb_filter, filter_length, activation, border_mode,
                         subsample_length, atrous_rate, use_bias,
                         init_method, W_regularizer, b_regularizer,
                         input_shape, name)


class Convolution2D(_ConvND):
    def __init__(self, nb_filter: int = 1, nb_row: int = 3, nb_col: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", use_bias: bool = True,
                 init_method: str = "glorot_uniform",
                 W_regularizer: Any = None, b_regularizer: Any = None,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(2, nb_filter, (nb_row, nb_col), subsample, None,
                         border_mode, activation, dim_ordering, use_bias,
                         input_shape, name)
        self.nb_row, self.nb_col, self.subsample = nb_row, nb_col, subsample
        self.init_method = init_method
        self.W_regularizer, self.b_regularizer = W_regularizer, b_regularizer


class AtrousConvolution2D(Convolution2D):
    """Dilated by ``atrous_rate``."""

    def __init__(self, nb_filter: int = 1, nb_row: int = 3, nb_col: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", use_bias: bool = True,
                 init_method: str = "glorot_uniform",
                 W_regularizer: Any = None, b_regularizer: Any = None,
                 input_shape: Any = None,
                 atrous_rate: Tuple[int, int] = (1, 1),
                 name: Optional[str] = None):
        _ConvND.__init__(self, 2, nb_filter, (nb_row, nb_col), subsample,
                         atrous_rate, border_mode, activation, dim_ordering,
                         use_bias, input_shape, name)


class ShareConvolution2D(Convolution2D):
    """Convolution2D with the same signature (the reference shares
    workspace memory between replicas; torch owns its buffers)."""


class Convolution3D(_ConvND):
    def __init__(self, nb_filter: int = 1, kernel_dim1: int = 3,
                 kernel_dim2: int = 3, kernel_dim3: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int, int] = (1, 1, 1),
                 dim_ordering: str = "th", use_bias: bool = True,
                 init_method: str = "glorot_uniform",
                 W_regularizer: Any = None, b_regularizer: Any = None,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(3, nb_filter, (kernel_dim1, kernel_dim2,
                                        kernel_dim3), subsample, None,
                         border_mode, activation, dim_ordering, use_bias,
                         input_shape, name)


class Deconvolution2D(Layer):
    """Transposed convolution (flax's ``nn.ConvTranspose``)."""

    def __init__(self, nb_filter: int = 1, nb_row: int = 3, nb_col: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", use_bias: bool = True,
                 init_method: str = "glorot_uniform",
                 output_shape: Any = None, W_regularizer: Any = None,
                 b_regularizer: Any = None, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.activation, self.dim_ordering = activation, dim_ordering
        self.ConvTranspose_0 = FlaxConvTranspose(
            nb_filter, (nb_row, nb_col), tuple(subsample),
            _pad_mode(border_mode), use_bias)

    def forward(self, x):
        y = self.ConvTranspose_0(_channels_first(x, self.dim_ordering))
        return _channels_back(activations.get(self.activation)(y),
                              self.dim_ordering)


class SeparableConvolution2D(Layer):
    """A depthwise convolution (``Conv_0``, one group a channel, no bias)
    followed by a 1x1 convolution (``Conv_1``)."""

    def __init__(self, nb_filter: int = 1, nb_row: int = 3, nb_col: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1),
                 depth_multiplier: int = 1, dim_ordering: str = "th",
                 use_bias: bool = True, init_method: str = "glorot_uniform",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.activation, self.dim_ordering = activation, dim_ordering
        self.Conv_0 = FlaxConv(None, (nb_row, nb_col), subsample,
                               _pad_mode(border_mode), use_bias=False,
                               depth_multiplier=depth_multiplier)
        self.Conv_1 = FlaxConv(nb_filter, (1, 1), use_bias=use_bias)

    def forward(self, x):
        y = self.Conv_1(self.Conv_0(_channels_first(x, self.dim_ordering)))
        return _channels_back(activations.get(self.activation)(y),
                              self.dim_ordering)


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int):
    """flax's ``glorot_uniform`` on a kernel ``(*positions, in, out)``:
    both fans count every position (the receptive field)."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-limit, limit)


class LocallyConnected1D(LazyModuleMixin, Layer):
    """A convolution with its own weights at every output position:
    ``y[b, l] = patches[b, l] @ W[l]`` over VALID windows."""

    def __init__(self, nb_filter: int = 1, filter_length: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 subsample_length: int = 1, use_bias: bool = True,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.nb_filter, self.filter_length = nb_filter, filter_length
        self.subsample_length, self.activation = subsample_length, activation
        self.use_bias = use_bias
        self.weight = UninitializedParameter()
        if use_bias:
            self.bias = UninitializedParameter()
        else:
            self.register_parameter("bias", None)

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            steps, dim = x.shape[1], x.shape[2]
            out_len = (steps - self.filter_length) // self.subsample_length + 1
            fan_in = self.filter_length * dim
            with torch.no_grad():
                self.weight.materialize((self.nb_filter, fan_in, out_len))
                _glorot_uniform_(self.weight, fan_in * out_len,
                                 self.nb_filter * out_len)
                if self.bias is not None:
                    self.bias.materialize((out_len, self.nb_filter))
                    self.bias.zero_()

    def forward(self, x):
        # (b, steps, dim) -> windows (b, L, dim, k) -> (b, L, k * dim)
        patches = x.unfold(1, self.filter_length, self.subsample_length)
        patches = patches.transpose(2, 3).reshape(x.shape[0],
                                                  patches.shape[1], -1)
        y = torch.einsum("bli,oil->blo", patches, self.weight)
        if self.bias is not None:
            y = y + self.bias
        return activations.get(self.activation)(y)


class LocallyConnected2D(LazyModuleMixin, Layer):
    """Per-position weights over VALID ``nb_row x nb_col`` windows."""

    def __init__(self, nb_filter: int = 1, nb_row: int = 3, nb_col: int = 3,
                 activation: Optional[Union[str, Callable]] = None,
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", use_bias: bool = True,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.nb_filter, self.kernel = nb_filter, (nb_row, nb_col)
        self.subsample, self.activation = tuple(subsample), activation
        self.dim_ordering = dim_ordering
        self.weight = UninitializedParameter()
        if use_bias:
            self.bias = UninitializedParameter()
        else:
            self.register_parameter("bias", None)

    def _out(self, h, w):
        (kr, kc), (sr, sc) = self.kernel, self.subsample
        return (h - kr) // sr + 1, (w - kc) // sc + 1

    def initialize_parameters(self, x) -> None:
        if self.has_uninitialized_params():
            x = _channels_first(x, self.dim_ordering)
            oh, ow = self._out(x.shape[2], x.shape[3])
            fan_in = self.kernel[0] * self.kernel[1] * x.shape[1]
            with torch.no_grad():
                self.weight.materialize((self.nb_filter, fan_in, oh, ow))
                _glorot_uniform_(self.weight, fan_in * oh * ow,
                                 self.nb_filter * oh * ow)
                if self.bias is not None:
                    self.bias.materialize((oh, ow, self.nb_filter))
                    self.bias.zero_()

    def forward(self, x):
        x = _channels_first(x, self.dim_ordering).movedim(1, -1)
        (kr, kc), (sr, sc) = self.kernel, self.subsample
        # (b, h, w, c) -> (b, oh, ow, c, kr, kc) -> (b, oh, ow, kr*kc*c)
        p = x.unfold(1, kr, sr).unfold(2, kc, sc)
        p = p.permute(0, 1, 2, 4, 5, 3).reshape(p.shape[0], p.shape[1],
                                                 p.shape[2], -1)
        y = torch.einsum("bhwi,oihw->bhwo", p, self.weight)
        if self.bias is not None:
            y = y + self.bias
        y = activations.get(self.activation)(y)
        return _channels_back(y.movedim(-1, 1), self.dim_ordering)


class Cropping1D(Layer):
    def __init__(self, cropping: Tuple[int, int] = (1, 1),
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.cropping = tuple(cropping)

    def forward(self, x):
        a, b = self.cropping
        return x[:, a:x.shape[1] - b, :]


class Cropping2D(Layer):
    def __init__(self, cropping=((0, 0), (0, 0)), dim_ordering: str = "th",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.cropping, self.dim_ordering = cropping, dim_ordering

    def forward(self, x):
        (t, bm), (l, r) = self.cropping
        if self.dim_ordering == "th":
            return x[:, :, t:x.shape[2] - bm, l:x.shape[3] - r]
        return x[:, t:x.shape[1] - bm, l:x.shape[2] - r, :]


class Cropping3D(Layer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)),
                 dim_ordering: str = "th", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.cropping, self.dim_ordering = cropping, dim_ordering

    def forward(self, x):
        (a1, b1), (a2, b2), (a3, b3) = self.cropping
        if self.dim_ordering == "th":
            return x[:, :, a1:x.shape[2] - b1, a2:x.shape[3] - b2,
                     a3:x.shape[4] - b3]
        return x[:, a1:x.shape[1] - b1, a2:x.shape[2] - b2,
                 a3:x.shape[3] - b3, :]


def _zero_pad(x, pads, dim_ordering, spatial_ndim):
    """Zero ``pads`` ``[(start, end)]`` on the spatial axes."""
    start = 2 if dim_ordering == "th" else 1
    cfg = [(0, 0)] * x.dim()
    for i, pair in enumerate(pads):
        cfg[start + i] = tuple(pair)
    return F.pad(x, _torch_pads(cfg))


class ZeroPadding1D(Layer):
    def __init__(self, padding: Union[int, Tuple[int, int]] = 1,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        p = padding
        self.padding = (p, p) if isinstance(p, int) else tuple(p)

    def forward(self, x):
        return _zero_pad(x, [self.padding], "tf", 1)


class ZeroPadding2D(Layer):
    def __init__(self, padding: Tuple = (1, 1), dim_ordering: str = "th",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.padding, self.dim_ordering = tuple(padding), dim_ordering

    def forward(self, x):
        p = self.padding
        pads = ((p[0], p[0]), (p[1], p[1])) if len(p) == 2 else \
            ((p[0], p[1]), (p[2], p[3]))
        return _zero_pad(x, pads, self.dim_ordering, 2)


class ZeroPadding3D(Layer):
    def __init__(self, padding: Tuple[int, int, int] = (1, 1, 1),
                 dim_ordering: str = "th", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.padding, self.dim_ordering = tuple(padding), dim_ordering

    def forward(self, x):
        p = self.padding
        return _zero_pad(x, [(q, q) for q in p], self.dim_ordering, 3)


def _upsample(x, factors, start_axis):
    for i, f in enumerate(factors):
        x = x.repeat_interleave(f, dim=start_axis + i)
    return x


class UpSampling1D(Layer):
    def __init__(self, length: int = 2, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.length = length

    def forward(self, x):
        return _upsample(x, (self.length,), 1)


class UpSampling2D(Layer):
    def __init__(self, size: Tuple[int, int] = (2, 2),
                 dim_ordering: str = "th", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.size, self.dim_ordering = tuple(size), dim_ordering

    def forward(self, x):
        return _upsample(x, self.size, 2 if self.dim_ordering == "th" else 1)


class UpSampling3D(Layer):
    def __init__(self, size: Tuple[int, int, int] = (2, 2, 2),
                 dim_ordering: str = "th", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.size, self.dim_ordering = tuple(size), dim_ordering

    def forward(self, x):
        return _upsample(x, self.size, 2 if self.dim_ordering == "th" else 1)

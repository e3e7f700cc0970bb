"""The rest of the reference's image-classification families (counterpart
of ``analytics_zoo_tpu/models/image/imageclassification/families.py``):
``AlexNet``, ``VGG`` (``VGG16``, ``VGG19``), ``MobileNetV1``,
``MobileNetV2`` (with ``return_features``), ``SqueezeNet``,
``DenseNet121`` and ``_conv_bn_act``.

The modules compute what the flax ones compute, over NHWC input as the
zoo's callers feed it, and their submodules carry flax's names
(``Conv_{i}``, ``Dense_{i}``, ``{name}_conv`` / ``{name}_bn`` of
``_conv_bn_act``, ``block{b}_{r}``, ``fire{i}``, ``dense{b}``, ...), so
``interop`` maps the two trees leaf by leaf. What stands in for flax:

* :class:`Conv`, flax ``nn.Conv``: ``SAME`` padding is flax's
  (``resnet.same_pads``: a stride-2 3x3 conv over an even input pads (0,
  1)); ``feature_group_count=C`` is torch's ``groups=C`` (flax's ``(kh,
  kw, 1, C)`` kernel is torch's ``(C, 1, kh, kw)``); the bias is added in
  the compute dtype after the conv, as flax adds it.
* :func:`max_pool`, flax ``nn.max_pool``: ``VALID`` by default, ``SAME``
  and explicit pads fill with -inf (torch's symmetric ``padding`` is
  neither when a ``SAME`` pad is lopsided).
* ``flatten_nhwc``: AlexNet's and VGG's first Dense sees the NHWC order
  that flax's ``reshape`` gives. Its input width is torch's lazy one, set
  by the first batch (flax sizes it from the input too).
* BatchNorm is flax's (``models/common/batch_norm.py``): the biased batch
  variance, momentum 0.9 and epsilon 1e-5 in ``_conv_bn_act``; DenseNet's
  own ``bn{i}a``/``bn{i}b``/``final_bn`` take flax's defaults, momentum
  0.99 and epsilon 1e-5.
* Dropout is ``torch.nn.Dropout`` at the JAX rates (``dropout`` modules:
  a test that compares train steps sets their ``p`` to 0, as it patches
  flax's).

Dtypes as in flax: f32 parameters and statistics, convs, BatchNorm and
hidden Dense layers in ``compute_dtype`` (bf16 by default), the f32 head.
Initialisation as flax's: conv and Dense kernels lecun-normal, biases 0,
BatchNorm scale 1 and bias 0. Activations are ``(B, C, H, W)``-shaped
tensors over NHWC memory, as the input arrives, so cuDNN takes its
channels-last paths.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.lazy import LazyModuleMixin

from ...common.batch_norm import BatchNorm
from ...common.initializers import as_torch_dtype, lecun_normal_
from ..resnet import same_pads

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(shape, kernel, strides, padding) -> Pads:
    if padding == "SAME":
        return tuple(same_pads(n, k, s)
                     for n, k, s in zip(shape, kernel, strides))
    if padding == "VALID":
        return ((0, 0), (0, 0))
    return tuple(tuple(p) for p in padding)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, padding, use_bias,
    feature_group_count, dtype)``; the kernel is ``weight`` in torch's
    ``(out, in / groups, kh, kw)`` order. ``dtype`` None computes in the
    input's dtype (the SSD keys its compute dtype off its input)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1, padding: Union[str, Pads] = "SAME",
                 use_bias: bool = True, groups: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.strides = _pair(kernel_size), _pair(strides)
        self.padding, self.groups = padding, groups
        self.dtype = None if dtype is None else as_torch_dtype(dtype)
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(
            torch.empty(features, in_features // groups, kh, kw))
        lecun_normal_(self.weight, kh * kw * in_features // groups)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x if self.dtype is None else x.to(self.dtype)
        (top, bottom), (left, right) = _pads(x.shape[2:], self.kernel_size,
                                             self.strides, self.padding)
        if top == bottom and left == right:
            padding = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        y = F.conv2d(x, w, None, self.strides, padding, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class Dense(nn.Linear):
    """flax ``nn.Dense(features, dtype)``: input, kernel and bias cast to
    ``dtype``; lecun-normal kernel, zero bias."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32):
        self.dtype = as_torch_dtype(dtype)
        super().__init__(in_features, features)

    def reset_parameters(self) -> None:
        if self.in_features == 0:
            return
        with torch.no_grad():
            lecun_normal_(self.weight, self.in_features)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LazyDense(LazyModuleMixin, Dense):
    """:class:`Dense` whose input width is set by the first input, as flax
    sizes a Dense; it becomes a :class:`Dense` then."""

    cls_to_become = Dense

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__(0, 0, dtype)
        self.weight = nn.UninitializedParameter()
        self.bias = nn.UninitializedParameter()
        self.out_features = features

    def reset_parameters(self) -> None:
        if not self.has_uninitialized_params():
            super().reset_parameters()

    def initialize_parameters(self, x: torch.Tensor) -> None:
        if self.has_uninitialized_params():
            with torch.no_grad():
                self.in_features = x.shape[-1]
                self.weight.materialize((self.out_features,
                                         self.in_features))
                self.bias.materialize((self.out_features,))
                self.reset_parameters()


def max_pool(x: torch.Tensor, window, strides, padding="VALID"
             ) -> torch.Tensor:
    """flax ``nn.max_pool``: pads (SAME or explicit) fill with -inf."""
    window, strides = _pair(window), _pair(strides)
    (top, bottom), (left, right) = _pads(x.shape[2:], window, strides,
                                         padding)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, window, strides)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """flax's ``x.reshape(B, -1)`` of the NHWC activation."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _input(x: torch.Tensor, dt) -> torch.Tensor:
    """An NHWC batch as a (B, C, H, W)-shaped tensor over NHWC memory, in
    ``dt`` (None: as it is)."""
    return (x if dt is None else x.to(dt)).permute(0, 3, 1, 2)


def _head(x: torch.Tensor, logits_of, return_logits: bool) -> torch.Tensor:
    logits = logits_of(x)
    return logits if return_logits else torch.softmax(logits, -1)


def add_conv_bn(parent: nn.Module, name: str, in_features: int,
                features: int, kernel, strides, dtype, groups: int = 1,
                epsilon: float = 1e-5) -> None:
    """The ``{name}_conv`` and ``{name}_bn`` submodules of
    ``_conv_bn_act`` (Inception-V1's take epsilon 1e-3), registered on
    ``parent`` as flax names them."""
    parent.add_module(f"{name}_conv", Conv(
        in_features, features, kernel, strides, use_bias=False,
        groups=groups, dtype=dtype))
    parent.add_module(f"{name}_bn", BatchNorm(features, momentum=0.9,
                                              epsilon=epsilon))


def _conv_bn_act(parent: nn.Module, x: torch.Tensor, name: str,
                 act=F.relu) -> torch.Tensor:
    """flax's ``_conv_bn_act``: SAME conv without bias, BatchNorm
    (momentum 0.9), then ``act`` (None: none)."""
    x = getattr(parent, f"{name}_bn")(getattr(parent, f"{name}_conv")(x))
    return act(x) if act is not None else x


class AlexNet(nn.Module):
    """AlexNet (caffe variant the reference ships)."""

    def __init__(self, num_classes: int = 1000,
                 compute_dtype=torch.bfloat16, return_logits: bool = True):
        super().__init__()
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        self.Conv_0 = Conv(3, 64, 11, 4, ((2, 2), (2, 2)), dtype=dt)
        self.Conv_1 = Conv(64, 192, 5, dtype=dt)
        self.Conv_2 = Conv(192, 384, 3, dtype=dt)
        self.Conv_3 = Conv(384, 256, 3, dtype=dt)
        self.Conv_4 = Conv(256, 256, 3, dtype=dt)
        self.Dense_0 = LazyDense(4096, dt)
        self.Dense_1 = Dense(4096, 4096, dt)
        self.Dense_2 = Dense(4096, num_classes)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _input(x, self.compute_dtype)
        x = max_pool(F.relu(self.Conv_0(x)), 3, 2)
        x = max_pool(F.relu(self.Conv_1(x)), 3, 2)
        x = F.relu(self.Conv_2(x))
        x = F.relu(self.Conv_3(x))
        x = max_pool(F.relu(self.Conv_4(x)), 3, 2)
        x = self.dropout(F.relu(self.Dense_0(flatten_nhwc(x))))
        x = self.dropout(F.relu(self.Dense_1(x)))
        return _head(x, self.Dense_2, self.return_logits)


class VGG(nn.Module):
    """VGG-16/19 (configuration D/E), BN variant — the reference ships
    VGG-16/19 ImageNet models."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 3, 3, 3),
                 num_classes: int = 1000, compute_dtype=torch.bfloat16,
                 return_logits: bool = True):
        super().__init__()
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        self.names = []
        cin = 3
        for si, (n_convs, feats) in enumerate(zip(
                stage_sizes, (64, 128, 256, 512, 512))):
            stage = []
            for ci in range(n_convs):
                add_conv_bn(self, f"s{si}c{ci}", cin, feats, 3, 1, dt)
                stage.append(f"s{si}c{ci}")
                cin = feats
            self.names.append(stage)
        self.Dense_0 = LazyDense(4096, dt)
        self.Dense_1 = Dense(4096, 4096, dt)
        self.Dense_2 = Dense(4096, num_classes)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _input(x, self.compute_dtype)
        for stage in self.names:
            for name in stage:
                x = _conv_bn_act(self, x, name)
            x = max_pool(x, 2, 2)
        x = self.dropout(F.relu(self.Dense_0(flatten_nhwc(x))))
        x = self.dropout(F.relu(self.Dense_1(x)))
        return _head(x, self.Dense_2, self.return_logits)


VGG16 = partial(VGG, stage_sizes=(2, 2, 3, 3, 3))
VGG19 = partial(VGG, stage_sizes=(2, 2, 4, 4, 4))


class MobileNetV1(nn.Module):
    """MobileNet (arXiv:1704.04861): depthwise-separable stacks."""

    PLAN = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            *[(512, 1)] * 5, (1024, 2), (1024, 1)]

    def __init__(self, num_classes: int = 1000, width: float = 1.0,
                 compute_dtype=torch.bfloat16, return_logits: bool = True):
        super().__init__()
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits, self.width = return_logits, width
        cin = self._ch(32)
        add_conv_bn(self, "stem", 3, cin, 3, 2, dt)
        self.strides = []
        for i, (feats, stride) in enumerate(self.PLAN):
            add_conv_bn(self, f"dw{i}", cin, cin, 3, stride, dt, groups=cin)
            add_conv_bn(self, f"pw{i}", cin, self._ch(feats), 1, 1, dt)
            cin = self._ch(feats)
        self.Dense_0 = Dense(cin, num_classes)

    def _ch(self, c: int) -> int:
        return max(8, int(c * self.width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_bn_act(self, _input(x, self.compute_dtype), "stem")
        for i in range(len(self.PLAN)):
            x = _conv_bn_act(self, x, f"dw{i}")
            x = _conv_bn_act(self, x, f"pw{i}")
        return _head(x.mean(dim=(2, 3)), self.Dense_0, self.return_logits)


class _InvertedResidual(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int,
                 expand: int, dtype):
        super().__init__()
        self.expand = expand
        self.residual = stride == 1 and in_features == features
        hidden = in_features * expand
        if expand != 1:
            add_conv_bn(self, "expand", in_features, hidden, 1, 1, dtype)
        add_conv_bn(self, "dw", hidden, hidden, 3, stride, dtype,
                    groups=hidden)
        add_conv_bn(self, "project", hidden, features, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.expand != 1:
            h = _conv_bn_act(self, h, "expand", F.relu6)
        h = _conv_bn_act(self, h, "dw", F.relu6)
        h = _conv_bn_act(self, h, "project", None)
        return h + x if self.residual else h


class MobileNetV2(nn.Module):
    """MobileNet-V2 (arXiv:1801.04381): inverted residuals.

    ``return_features=True`` skips the classifier and returns the
    (stride-16, stride-32) feature maps — the taps SSD-MobileNet detection
    heads hang off (objectdetection/ssd.py SSDMobileNetV2)."""

    # (expand, features, repeats, first-stride)
    PLAN = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]

    def __init__(self, num_classes: int = 1000,
                 compute_dtype=torch.bfloat16, return_logits: bool = True,
                 return_features: bool = False):
        super().__init__()
        # None: the input's dtype (SSDMobileNetV2's backbone)
        self.compute_dtype = dt = None if compute_dtype is None \
            else as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        self.return_features = return_features
        add_conv_bn(self, "stem", 3, 32, 3, 2, dt)
        self.blocks = []
        cin = 32
        for bi, (t, c, n, s) in enumerate(self.PLAN):
            for ri in range(n):
                name = f"block{bi}_{ri}"
                self.add_module(name, _InvertedResidual(
                    cin, c, s if ri == 0 else 1, t, dt))
                self.blocks.append((bi, name))
                cin = c
        add_conv_bn(self, "head", cin, 1280, 1, 1, dt)
        if not return_features:
            self.Dense_0 = Dense(1280, num_classes)

    def forward(self, x: torch.Tensor):
        x = _conv_bn_act(self, _input(x, self.compute_dtype), "stem",
                         F.relu6)
        f16 = None
        for bi, name in self.blocks:
            x = getattr(self, name)(x)
            if bi == 4:                     # end of the stride-16 stages
                f16 = x
        x = _conv_bn_act(self, x, "head", F.relu6)
        if self.return_features:
            return f16, x                   # stride 16, stride 32
        return _head(x.mean(dim=(2, 3)), self.Dense_0, self.return_logits)


class _FireModule(nn.Module):
    def __init__(self, in_features: int, squeeze: int, expand: int, dtype):
        super().__init__()
        self.squeeze = Conv(in_features, squeeze, 1, dtype=dtype)
        self.e1x1 = Conv(squeeze, expand, 1, dtype=dtype)
        self.e3x3 = Conv(squeeze, expand, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.squeeze(x))
        return torch.cat([F.relu(self.e1x1(s)), F.relu(self.e3x3(s))], 1)


class SqueezeNet(nn.Module):
    """SqueezeNet v1.1 (arXiv:1602.07360)."""

    FIRES = ((2, 16, 64), (3, 16, 64), "pool", (4, 32, 128), (5, 32, 128),
             "pool", (6, 48, 192), (7, 48, 192), (8, 64, 256), (9, 64, 256))

    def __init__(self, num_classes: int = 1000,
                 compute_dtype=torch.bfloat16, return_logits: bool = True):
        super().__init__()
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        self.Conv_0 = Conv(3, 64, 3, 2, dtype=dt)
        cin = 64
        for fire in self.FIRES:
            if fire != "pool":
                i, sq, ex = fire
                self.add_module(f"fire{i}", _FireModule(cin, sq, ex, dt))
                cin = 2 * ex
        self.dropout = nn.Dropout(0.5)
        self.conv10 = Conv(cin, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Conv_0(_input(x, self.compute_dtype)))
        x = max_pool(x, 3, 2)
        for fire in self.FIRES:
            x = max_pool(x, 3, 2) if fire == "pool" else \
                getattr(self, f"fire{fire[0]}")(x)
        x = self.conv10(self.dropout(x)).mean(dim=(2, 3))
        return x if self.return_logits else torch.softmax(x, -1)


class _DenseBlock(nn.Module):
    def __init__(self, in_features: int, layers: int, growth: int, dtype):
        super().__init__()
        self.layers = layers
        cin = in_features
        for i in range(layers):
            # flax nn.BatchNorm's defaults: momentum 0.99, epsilon 1e-5
            self.add_module(f"bn{i}a", BatchNorm(cin, momentum=0.99))
            self.add_module(f"conv{i}a", Conv(cin, 4 * growth, 1,
                                              use_bias=False, dtype=dtype))
            self.add_module(f"bn{i}b", BatchNorm(4 * growth, momentum=0.99))
            self.add_module(f"conv{i}b", Conv(4 * growth, growth, 3,
                                              use_bias=False, dtype=dtype))
            cin += growth
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            h = getattr(self, f"conv{i}a")(F.relu(getattr(self, f"bn{i}a")(x)))
            h = getattr(self, f"conv{i}b")(F.relu(getattr(self, f"bn{i}b")(h)))
            x = torch.cat([x, h], 1)
        return x


class DenseNet121(nn.Module):
    """DenseNet-121 (arXiv:1608.06993)."""

    BLOCKS = (6, 12, 24, 16)

    def __init__(self, num_classes: int = 1000, growth: int = 32,
                 compute_dtype=torch.bfloat16, return_logits: bool = True):
        super().__init__()
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        add_conv_bn(self, "stem", 3, 2 * growth, 7, 2, dt)
        cin = 2 * growth
        for bi, layers in enumerate(self.BLOCKS):
            block = _DenseBlock(cin, layers, growth, dt)
            self.add_module(f"dense{bi}", block)
            cin = block.out_features
            if bi < 3:                     # transition: halve channels + pool
                add_conv_bn(self, f"trans{bi}", cin, cin // 2, 1, 1, dt)
                cin //= 2
        self.final_bn = BatchNorm(cin, momentum=0.99)
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_bn_act(self, _input(x, self.compute_dtype), "stem")
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for bi in range(len(self.BLOCKS)):
            x = getattr(self, f"dense{bi}")(x)
            if bi < 3:
                x = F.avg_pool2d(_conv_bn_act(self, x, f"trans{bi}"), 2, 2)
        x = F.relu(self.final_bn(x)).mean(dim=(2, 3))
        return _head(x, self.Dense_0, self.return_logits)

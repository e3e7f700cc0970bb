"""ResNet v1.5 family (counterpart of ``analytics_zoo_tpu/models/image/
resnet.py``): ``BottleneckBlock``, ``BasicBlock``, ``SpaceToDepthStem``,
``ResNet``, ``ResNet18/34/50/101/152`` and ``resnet(depth, num_classes)``.

The modules compute what the flax ones compute, and their submodules carry
flax's names (``conv_init``, ``bn_init``, ``BottleneckBlock_{i}`` holding
``Conv_{j}``, ``BatchNorm_{j}``, ``proj_conv`` and ``proj_bn``, then
``head``), so ``interop`` maps the two trees leaf by leaf. Two building
blocks stand in for flax's layers:

* :class:`Conv`, flax ``nn.Conv`` without a bias: the input and kernel are
  cast to ``dtype`` and ``SAME`` padding is flax's, total = max((ceil(in /
  s) - 1) * s + k - in, 0) split as lo = total // 2, hi = total - lo. A
  3x3 stride-2 conv over an even input is padded (0, 1), not (1, 1); such
  a pad goes through ``F.pad``, a symmetric one into the conv itself.
* :class:`BatchNorm` (``models/common/batch_norm.py``), flax
  ``nn.BatchNorm``: it normalises with f32 batch
  statistics (training) or the running ones (evaluation) and writes its
  output in the input's dtype; a train step updates ``running_mean`` and
  ``running_var`` with momentum 0.9 towards the batch mean and the
  *biased* batch variance (``torch.nn.BatchNorm2d`` takes the unbiased
  one, and counts batches; this one does not).

Dtypes as in flax: f32 parameters and statistics, convs and BatchNorm
outputs in ``compute_dtype``, the f32 head. A uint8 ``(B, H, W, 3)`` batch
is normalised inside the model, ``(x - mean) * (1 / std)`` in
``compute_dtype`` with the constants rounded to it. Activations stay
channels-last: ``(B, C, H, W)``-shaped tensors over NHWC memory, as the
input arrives, so cuDNN takes its NHWC paths.

Initialisation as flax's (``models/common/initializers``): conv and Dense
kernels lecun-normal, the Dense bias zero, BatchNorm scale 1 and bias 0,
and scale 0 on each block's last BatchNorm. Draws come from torch's global
generator, as ``torch.nn`` layers draw theirs.

One difference of structure: flax decides a block's projection from the
shapes it sees, a torch module when it is built; a block here projects
when its channels change or it strides, which is the same decision at
every input of two pixels or more on the side it strides.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...orca.data.image.imagenet import IMAGENET_MEAN, IMAGENET_STD
from ..common.batch_norm import (BN_EPSILON, BN_MOMENTUM,  # noqa: F401
                                 BatchNorm)
from ..common.initializers import as_torch_dtype, lecun_normal_

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``SAME`` padding of one spatial axis: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_nchw(x: torch.Tensor, weight: torch.Tensor, stride, pads: Pads
              ) -> torch.Tensor:
    """``F.conv2d`` of a channels-last ``x`` with the (lo, hi) pads of
    each spatial axis; the kernel goes channels-last too."""
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        padding = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
        padding = (0, 0)
    w = weight.to(dtype=x.dtype, memory_format=torch.channels_last)
    return F.conv2d(x, w, None, stride, padding)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, use_bias=False,
    dtype=dtype)``; the kernel is ``weight`` in torch's ``(out, in, kh,
    kw)`` order (flax's is ``(kh, kw, in, out)``). ``padding`` is "SAME" or
    explicit ((top, bottom), (left, right))."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=1, padding: Union[str, Pads] = "SAME",
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.strides = _pair(kernel_size), _pair(strides)
        self.padding = padding
        self.dtype = as_torch_dtype(dtype)
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(features, in_features, kh, kw))
        lecun_normal_(self.weight, kh * kw * in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding == "SAME":
            pads = tuple(same_pads(n, k, s) for n, k, s in zip(
                x.shape[2:], self.kernel_size, self.strides))
        else:
            pads = self.padding
        return conv_nchw(x.to(self.dtype), self.weight, self.strides, pads)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided, v1.5) -> 1x1 x4, each with BatchNorm, the last
    BatchNorm's scale starting at 0; a projection when the shape
    changes."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, strides=(1, 1),
                 dtype=torch.bfloat16):
        super().__init__()
        out = filters * self.expansion
        self.Conv_0 = Conv(in_features, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(out, scale_init=0.0)
        self.project = in_features != out or _pair(strides) != (1, 1)
        if self.project:
            self.proj_conv = Conv(in_features, out, 1, strides, dtype=dtype)
            self.proj_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.project else x
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 (strided) -> 3x3, each with BatchNorm, the last BatchNorm's
    scale starting at 0; a projection when the shape changes."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, strides=(1, 1),
                 dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = Conv(in_features, filters, 3, strides, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, scale_init=0.0)
        self.project = in_features != filters or _pair(strides) != (1, 1)
        if self.project:
            self.proj_conv = Conv(in_features, filters, 1, strides,
                                  dtype=dtype)
            self.proj_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.proj_bn(self.proj_conv(x)) if self.project else x
        return F.relu(residual + y)


class SpaceToDepthStem(nn.Module):
    """The 7x7 stride-2 stem over 3 channels computed as a 4x4 stride-1
    conv over the 2x2 space-to-depth input (12 channels): the 7x7 kernel is
    padded to 8x8 with one leading zero row and column and re-blocked, so
    the result is the same. The parameter keeps the 7x7 kernel
    (``weight``, ``(features, 3, 7, 7)``), so the two stems' checkpoints
    interchange. Takes and returns channels-last tensors."""

    def __init__(self, in_features: int = 3, features: int = 64,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = as_torch_dtype(dtype)
        self.weight = nn.Parameter(torch.empty(features, in_features, 7, 7))
        lecun_normal_(self.weight, 49 * in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return s2d_stem(x, self.weight, self.dtype)


def s2d_stem(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    """The stem conv of ``weight`` (``(features, c, 7, 7)``, stride 2,
    padding 3) over a channels-last ``(B, c, H, W)`` ``x`` with even H and
    W, computed over its space-to-depth blocks."""
    b, c, h, w = x.shape
    f = weight.shape[0]
    k = weight.permute(2, 3, 1, 0)                          # (7, 7, c, f)
    k8 = F.pad(k, (0, 0, 0, 0, 1, 0, 1, 0))                 # (8, 8, c, f)
    k8 = k8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
    k8 = k8.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1)     # (f, 4c, 4, 4)
    xs = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return conv_nchw(xs.permute(0, 3, 1, 2).to(dtype), k8, (1, 1),
                     ((2, 1), (2, 1)))


class ResNet(nn.Module):
    """ResNet v1.5 over uint8 ``(B, H, W, 3)`` images (or float ones, which
    are only cast); ``forward`` returns ``(B, num_classes)`` f32 logits, or
    their softmax unless ``return_logits``. ``stem`` is "conv7" or "s2d"
    (the same function; s2d falls back to conv7 on an odd-sized input).
    Train or evaluation mode is the module's ``training`` flag."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 compute_dtype=torch.bfloat16, return_logits: bool = True,
                 stem: str = "conv7"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits, self.stem = return_logits, stem
        self.conv_init = Conv(3, num_filters, 7, 2, ((3, 3), (3, 3)),
                              dtype=dt)
        self.bn_init = BatchNorm(num_filters)
        self.block_names = []
        width = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                block = block_cls(width, num_filters * 2 ** i, strides,
                                  dtype=dt)
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block)
                self.block_names.append(name)
                width = num_filters * 2 ** i * block_cls.expansion
        self.head = nn.Linear(width, num_classes)
        lecun_normal_(self.head.weight, width)
        with torch.no_grad():
            self.head.bias.zero_()
        self.register_buffer(
            "_mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float64),
            persistent=False)
        self.register_buffer(
            "_inv_std", torch.from_numpy(1.0 / np.asarray(IMAGENET_STD)),
            persistent=False)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        if self.stem == "s2d" and h % 2 == 0 and w % 2 == 0:
            return s2d_stem(x, self.conv_init.weight, self.compute_dtype)
        return self.conv_init(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if x.dtype == torch.uint8:
            x = (x.to(dt) - self._mean.to(dt)) * self._inv_std.to(dt)
        x = x.to(dt).permute(0, 3, 1, 2)        # NCHW shape, NHWC memory
        x = F.relu(self.bn_init(self._stem(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.head(x.mean(dim=(2, 3)).float())
        return x if self.return_logits else torch.softmax(x, -1)


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3),
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3),
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3),
                    block_cls=BottleneckBlock)


def resnet(depth: int = 50, num_classes: int = 1000, **kwargs) -> ResNet:
    table = {18: ResNet18, 34: ResNet34, 50: ResNet50, 101: ResNet101,
             152: ResNet152}
    if depth not in table:
        raise ValueError(f"unsupported resnet depth {depth}")
    return table[depth](num_classes=num_classes, **kwargs)

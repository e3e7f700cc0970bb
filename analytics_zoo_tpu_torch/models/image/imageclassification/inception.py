"""Inception v1 (GoogLeNet), counterpart of ``analytics_zoo_tpu/models/
image/imageclassification/inception.py``: ``InceptionBlock``,
``InceptionV1`` and ``V1_BLOCKS``.

The reference's headline ImageNet training workload (Scala twin:
zoo/.../examples/inception/Train.scala + Inception model in the BigDL zoo),
the "inception-v1 with BN" variant: BatchNorm follows each conv, and the
paper's auxiliary classifier heads are omitted, as in the JAX package.

As the flax module: NHWC input; a uint8 batch is normalised inside the
model with ``orca/data/image/imagenet.py``'s ``IMAGENET_MEAN`` /
``IMAGENET_STD``, ``(x - mean) * (1 / std)`` in ``compute_dtype`` with the
constants rounded to it; BatchNorm with epsilon 1e-3 and flax momentum 0.9
(``models/common/batch_norm.py``, the biased batch variance); every conv
without bias and ``SAME``; max pools ``SAME`` with -inf padding; dropout
0.4 before the f32 head; ``return_logits`` honoured; bf16 compute by
default. Submodules carry flax's names (``stem_conv``, ``stem_bn``,
``reduce_conv``, ..., ``inception_{3a..5b}`` holding ``b1_conv``,
``b2_reduce_conv``, ..., ``b4_proj_bn``, then ``head``), so ``interop``
maps the two trees leaf by leaf.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ....orca.data.image.imagenet import IMAGENET_MEAN, IMAGENET_STD
from ...common.initializers import as_torch_dtype
from .families import Dense, _conv_bn_act, add_conv_bn, max_pool

# (1x1, (3x3 reduce, 3x3), (5x5 reduce, 5x5), pool proj) per block
V1_BLOCKS: Sequence[Tuple] = (
    ("3a", 64, (96, 128), (16, 32), 32),
    ("3b", 128, (128, 192), (32, 96), 64),
    ("pool",),
    ("4a", 192, (96, 208), (16, 48), 64),
    ("4b", 160, (112, 224), (24, 64), 64),
    ("4c", 128, (128, 256), (24, 64), 64),
    ("4d", 112, (144, 288), (32, 64), 64),
    ("4e", 256, (160, 320), (32, 128), 128),
    ("pool",),
    ("5a", 256, (160, 320), (32, 128), 128),
    ("5b", 384, (192, 384), (48, 128), 128),
)

BN_EPSILON = 1e-3


def _add_cbr(parent: nn.Module, name: str, in_features: int, features: int,
             kernel, dtype, strides=1) -> None:
    add_conv_bn(parent, name, in_features, features, kernel, strides, dtype,
                epsilon=BN_EPSILON)


class InceptionBlock(nn.Module):
    def __init__(self, in_features: int, one: int, three: Tuple[int, int],
                 five: Tuple[int, int], pool_proj: int,
                 dtype=torch.bfloat16):
        super().__init__()
        _add_cbr(self, "b1", in_features, one, 1, dtype)
        _add_cbr(self, "b2_reduce", in_features, three[0], 1, dtype)
        _add_cbr(self, "b2", three[0], three[1], 3, dtype)
        _add_cbr(self, "b3_reduce", in_features, five[0], 1, dtype)
        _add_cbr(self, "b3", five[0], five[1], 5, dtype)
        _add_cbr(self, "b4_proj", in_features, pool_proj, 1, dtype)
        self.out_features = one + three[1] + five[1] + pool_proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = _conv_bn_act(self, x, "b1")
        b2 = _conv_bn_act(self, _conv_bn_act(self, x, "b2_reduce"), "b2")
        b3 = _conv_bn_act(self, _conv_bn_act(self, x, "b3_reduce"), "b3")
        b4 = _conv_bn_act(self, max_pool(x, 3, 1, "SAME"), "b4_proj")
        return torch.cat([b1, b2, b3, b4], 1)


class InceptionV1(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 compute_dtype=torch.bfloat16, dropout: float = 0.4,
                 return_logits: bool = True):
        super().__init__()
        self.compute_dtype = dt = as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        _add_cbr(self, "stem", 3, 64, 7, dt, strides=2)
        _add_cbr(self, "reduce", 64, 64, 1, dt)
        _add_cbr(self, "stem2", 64, 192, 3, dt)
        cin = 192
        self.blocks = []
        for cfg in V1_BLOCKS:
            if cfg[0] == "pool":
                self.blocks.append(None)
                continue
            name, one, three, five, proj = cfg
            block = InceptionBlock(cin, one, three, five, proj, dt)
            self.add_module(f"inception_{name}", block)
            self.blocks.append(f"inception_{name}")
            cin = block.out_features
        self.dropout = nn.Dropout(dropout)
        self.head = Dense(cin, num_classes)
        self.register_buffer(
            "_mean", torch.tensor(IMAGENET_MEAN, dtype=torch.float64),
            persistent=False)
        self.register_buffer(
            "_inv_std", torch.from_numpy(1.0 / np.asarray(IMAGENET_STD)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if x.dtype == torch.uint8:
            x = (x.to(dt) - self._mean.to(dt)) * self._inv_std.to(dt)
        x = x.to(dt).permute(0, 3, 1, 2)        # NCHW shape, NHWC memory
        x = max_pool(_conv_bn_act(self, x, "stem"), 3, 2, "SAME")
        x = _conv_bn_act(self, x, "reduce")
        x = max_pool(_conv_bn_act(self, x, "stem2"), 3, 2, "SAME")
        for name in self.blocks:
            x = max_pool(x, 3, 2, "SAME") if name is None else \
                getattr(self, name)(x)
        x = self.head(self.dropout(x.mean(dim=(2, 3))))
        return x if self.return_logits else torch.softmax(x, -1)

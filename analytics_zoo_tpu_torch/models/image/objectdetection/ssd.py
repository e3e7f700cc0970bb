"""SSD detector network (counterpart of ``analytics_zoo_tpu/models/image/
objectdetection/ssd.py``: ``SSD``, ``ssd_300``, ``ssd_tiny``).

Reference: ``zoo/.../models/image/objectdetection/ssd/SSDGraph.scala`` +
``SSD.scala`` (a conv trunk with extra stride-2 feature layers; per-scale
conv heads producing loc/conf for every prior).

The module computes what the flax one computes, over NHWC input as the
zoo's callers feed it:

* The feature pyramid is the flax module's: stride-2 ``SAME`` convs halve
  the map (ceil) until every size a ``PriorSpec`` names has been tapped
  for a head. ``SAME`` is flax's (``resnet.same_pads``): 300 -> 150 and
  150 -> 75 pad (0, 1), 75 -> 38 and 19 -> 10 pad (1, 1). SSD300's chain
  also runs the 3 -> 2 conv, which no head taps, on its way to 1.
* Submodules carry flax's names, so ``interop`` maps the two trees leaf by
  leaf: ``stem``, ``down{i}``, ``loc{size}``, ``conf{size}`` and flax's
  auto-named ``BatchNorm_{j}`` in creation order (``BatchNorm_0`` after the
  stem, ``BatchNorm_{i+1}`` after ``down{i}``).
* Each head's NCHW output is permuted to NHWC before the reshape to
  ``[B, H*W*k, 4]`` (flax reshapes NHWC), and heads concatenate largest
  map first, so the rows line up with :meth:`SSD.priors`.
* The compute dtype follows the input: bf16 input runs the trunk in bf16,
  anything else in f32; loc and conf come out f32. BatchNorm is flax's
  (``models/common/batch_norm.py``) at momentum 0.9.

Activations are ``(B, C, H, W)``-shaped tensors over NHWC memory, as the
input arrives, so cuDNN takes its channels-last paths.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...common.batch_norm import BatchNorm
from ..resnet import Conv, conv_nchw, same_pads
from .priors import PriorSpec, generate_priors, ssd300_specs, tiny_specs


def _fm_chain(image_size: int) -> Sequence[int]:
    sizes = []
    s = image_size
    while s > 1:
        s = -(-s // 2)  # ceil div — stride-2 SAME conv output size
        sizes.append(s)
    return sizes


class SameConv(Conv):
    """flax ``nn.Conv(features, (3, 3), strides, padding="SAME",
    use_bias=...)`` that computes in its input's dtype (the SSD keys its
    compute dtype off the input, so the layer has none of its own); the
    bias, when there is one, starts at zero as flax's does and is added in
    that dtype after the conv, as flax adds it."""

    def __init__(self, in_features: int, features: int, kernel_size=3,
                 strides=1, use_bias: bool = False):
        super().__init__(in_features, features, kernel_size, strides)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = tuple(same_pads(n, k, s) for n, k, s in zip(
            x.shape[2:], self.kernel_size, self.strides))
        y = conv_nchw(x, self.weight, self.strides, pads)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class SSD(nn.Module):
    """Single-shot detector over a generic stride-2 conv pyramid.
    ``forward(x)``: x ``[B, H, W, 3]`` float -> (loc ``[B, A, 4]``, conf
    ``[B, A, C]``), both f32; train or evaluation mode is the module's
    ``training`` flag."""

    def __init__(self, num_classes: int, image_size: int = 300,
                 specs: Sequence[PriorSpec] = (), base_width: int = 64,
                 max_width: int = 512):
        super().__init__()
        self.num_classes = int(num_classes)      # including background 0
        self.image_size = int(image_size)
        self.specs = tuple(specs) or tuple(ssd300_specs())
        self.base_width, self.max_width = int(base_width), int(max_width)
        chain = _fm_chain(self.image_size)
        for sp in self.specs:
            if sp.fm_size not in chain:
                raise ValueError(
                    f"PriorSpec fm_size={sp.fm_size} not reachable from "
                    f"image_size={self.image_size} (chain {list(chain)})")

        width = self.base_width
        self.stem = SameConv(3, width)
        self.BatchNorm_0 = BatchNorm(width)
        # (down conv name, its BatchNorm's name, head size or None)
        self.layers = []
        size, i = self.image_size, 0
        remaining = {sp.fm_size: sp for sp in self.specs}
        while size > 1 and remaining:
            prev, width = width, min(width * 2, self.max_width)
            self.add_module(f"down{i}", SameConv(prev, width, strides=2))
            self.add_module(f"BatchNorm_{i + 1}", BatchNorm(width))
            size = -(-size // 2)
            head = None
            if size in remaining:
                k = remaining.pop(size).num_priors
                self.add_module(f"loc{size}",
                                SameConv(width, k * 4, use_bias=True))
                self.add_module(f"conf{size}", SameConv(
                    width, k * self.num_classes, use_bias=True))
                head = size
            self.layers.append((f"down{i}", f"BatchNorm_{i + 1}", head))
            i += 1

    @property
    def config(self) -> Dict[str, Any]:
        """Plain values that rebuild this module: ``SSD(**config)`` (the
        specs as dicts)."""
        return {"num_classes": self.num_classes,
                "image_size": self.image_size,
                "specs": [asdict(sp) for sp in self.specs],
                "base_width": self.base_width, "max_width": self.max_width}

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "SSD":
        cfg = dict(config)
        cfg["specs"] = tuple(
            PriorSpec(sp["fm_size"], sp["min_size"], sp["max_size"],
                      tuple(sp["aspect_ratios"])) for sp in cfg["specs"])
        return cls(**cfg)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        x = x.to(dt).permute(0, 3, 1, 2)        # NCHW shape, NHWC memory
        x = F.relu(self.BatchNorm_0(self.stem(x)))
        b = x.shape[0]
        locs, confs = [], []
        for down, norm, head in self.layers:
            x = F.relu(getattr(self, norm)(getattr(self, down)(x)))
            if head is not None:
                loc = getattr(self, f"loc{head}")(x)
                conf = getattr(self, f"conf{head}")(x)
                locs.append(loc.permute(0, 2, 3, 1).reshape(b, -1, 4))
                confs.append(conf.permute(0, 2, 3, 1).reshape(
                    b, -1, self.num_classes))
        return (torch.cat(locs, 1).float(), torch.cat(confs, 1).float())

    def priors(self) -> np.ndarray:
        """Center-form [A, 4] prior constants matching the head order
        (largest feature map first)."""
        ordered = sorted(self.specs, key=lambda sp: -sp.fm_size)
        return generate_priors(self.image_size, ordered)


def ssd_300(num_classes: int, base_width: int = 64) -> SSD:
    """SSD300 ladder (the reference's VGG-SSD working resolution)."""
    return SSD(num_classes=num_classes, image_size=300,
               specs=tuple(ssd300_specs()), base_width=base_width)


def ssd_tiny(num_classes: int, image_size: int = 64,
             base_width: int = 16) -> SSD:
    """Small two-scale SSD for tests/toy data."""
    return SSD(num_classes=num_classes, image_size=image_size,
               specs=tuple(tiny_specs(image_size)), base_width=base_width,
               max_width=64)

"""SSD prior ("anchor" / "default") box generation (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/priors.py``, the same
numpy code, so the priors are the same bytes).

Reference: the SSD prior-box layers instantiated per feature map in
``zoo/.../models/image/objectdetection/ssd/SSDGraph.scala`` (min/max sizes +
aspect ratios per scale, the standard SSD300 schedule). Rebuilt as a
build-time numpy computation: priors are a constant [A, 4] center-form array
that the detector keeps on the device as a buffer, so there is no per-step
anchor generation at all.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class PriorSpec:
    """One feature-map scale of the SSD pyramid."""
    fm_size: int                 # feature map height == width
    min_size: float              # smaller prior scale, in pixels
    max_size: float              # sqrt(min*max) prior, in pixels
    aspect_ratios: Tuple[float, ...] = (2.0,)   # plus reciprocals

    @property
    def num_priors(self) -> int:
        # 1 (min) + 1 (sqrt(min*max)) + 2 per aspect ratio
        return 2 + 2 * len(self.aspect_ratios)


def ssd300_specs() -> List[PriorSpec]:
    """The classic SSD300 schedule (what the reference's VGG SSD uses)."""
    return [
        PriorSpec(38, 30, 60, (2.0,)),
        PriorSpec(19, 60, 111, (2.0, 3.0)),
        PriorSpec(10, 111, 162, (2.0, 3.0)),
        PriorSpec(5, 162, 213, (2.0, 3.0)),
        PriorSpec(3, 213, 264, (2.0,)),
        PriorSpec(1, 264, 315, (2.0,)),
    ]


def tiny_specs(image_size: int) -> List[PriorSpec]:
    """A two-scale schedule for small test images (image_size ~ 64-128)."""
    s = float(image_size)
    return [
        PriorSpec(image_size // 8, 0.2 * s, 0.45 * s, (2.0,)),
        PriorSpec(image_size // 16, 0.45 * s, 0.8 * s, (2.0,)),
    ]


def generate_priors(image_size: int, specs: Sequence[PriorSpec],
                    clip: bool = True) -> np.ndarray:
    """Build the full prior set: [sum_i fm_i^2 * num_priors_i, 4] center-form
    (cx, cy, w, h), normalized to [0, 1]."""
    out = []
    for spec in specs:
        step = 1.0 / spec.fm_size
        sizes_wh = []
        s_min = spec.min_size / image_size
        s_max = math.sqrt(spec.min_size * spec.max_size) / image_size
        sizes_wh.append((s_min, s_min))
        sizes_wh.append((s_max, s_max))
        for ar in spec.aspect_ratios:
            r = math.sqrt(ar)
            sizes_wh.append((s_min * r, s_min / r))
            sizes_wh.append((s_min / r, s_min * r))
        grid = (np.arange(spec.fm_size) + 0.5) * step
        cx, cy = np.meshgrid(grid, grid)               # [fm, fm]
        centers = np.stack([cx, cy], axis=-1).reshape(-1, 1, 2)
        wh = np.asarray(sizes_wh).reshape(1, -1, 2)
        cwh = np.broadcast_to(wh, (centers.shape[0], wh.shape[1], 2))
        c = np.broadcast_to(centers, cwh.shape)
        out.append(np.concatenate([c, cwh], axis=-1).reshape(-1, 4))
    priors = np.concatenate(out, axis=0).astype(np.float32)
    if clip:
        priors = np.clip(priors, 0.0, 1.0)
    return priors

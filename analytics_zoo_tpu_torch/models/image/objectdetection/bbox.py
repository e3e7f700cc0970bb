"""Box geometry primitives for object detection (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/bbox.py``).

Reference behavior: ``zoo/src/main/scala/com/intel/analytics/zoo/models/image/
objectdetection/common/BboxUtil.scala`` (encode/decode with prior variances,
jaccard overlap, clipping). Every function is a torch op over *batched* box
tensors ``[..., 4]`` and evaluates the JAX functions' formulas in their order,
so the loss and the postprocessor run as a few batched kernels and give the
JAX package's values to rounding. Boxes are normalized to [0, 1].

Conventions:
  * "corner" form: ``(x1, y1, x2, y2)``
  * "center" form: ``(cx, cy, w, h)`` — priors are stored in center form.
"""

from __future__ import annotations

from typing import Tuple

import torch

# SSD variances (BboxUtil encode/decode "variance" scaling)
DEFAULT_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def _variances(variances, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(variances, dtype=like.dtype, device=like.device)


def center_to_corner(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2). Works on [..., 4]."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h). Works on [..., 4]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Corner-form box area, [...] -> [...]."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between two corner-form box sets, batched over any
    leading dims: [..., M, 4] x [..., A, 4] -> [..., M, A]."""
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes_a)[..., :, None] + area(boxes_b)[..., None, :] - inter
    return inter / union.clamp_min(1e-10)


def encode_boxes(matched: torch.Tensor, priors: torch.Tensor,
                 variances: Tuple[float, ...] = DEFAULT_VARIANCES
                 ) -> torch.Tensor:
    """Encode corner-form GT boxes against center-form priors:
    [..., A, 4] x [A, 4] -> [..., A, 4] regression targets."""
    v = _variances(variances, matched)
    m = corner_to_center(matched)
    g_cxcy = (m[..., :2] - priors[..., :2]) / priors[..., 2:].clamp_min(1e-10)
    g_cxcy = g_cxcy / v[:2]
    g_wh = torch.log(m[..., 2:].clamp_min(1e-10) /
                     priors[..., 2:].clamp_min(1e-10))
    g_wh = g_wh / v[2:]
    return torch.cat([g_cxcy, g_wh], -1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances: Tuple[float, ...] = DEFAULT_VARIANCES
                 ) -> torch.Tensor:
    """Inverse of :func:`encode_boxes`: [..., A, 4] loc predictions ->
    corner-form boxes (BboxUtil.decodeBoxes)."""
    v = _variances(variances, loc)
    cxcy = priors[..., :2] + loc[..., :2] * v[:2] * priors[..., 2:]
    wh = priors[..., 2:] * torch.exp(loc[..., 2:] * v[2:])
    return center_to_corner(torch.cat([cxcy, wh], -1))


def clip_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """Clip corner-form boxes into [0, 1] (Postprocessor.scala clipBoxes)."""
    return boxes.clamp(0.0, 1.0)

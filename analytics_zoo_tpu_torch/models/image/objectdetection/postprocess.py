"""Detection postprocessing: decode -> threshold -> NMS -> top-k (counterpart
of ``analytics_zoo_tpu/models/image/objectdetection/postprocess.py``).

Reference: ``zoo/.../models/image/objectdetection/Postprocessor.scala``
(ScaleDetection / DecodeOutput) and the NMS inside ``BboxUtil.scala``.

The JAX package ``vmap``s one image's pipeline over the batch; here every
step runs on the whole batch at once, with the same static shapes:

* per-class NMS in ONE pass with the batched-NMS trick (each box offset by
  ``class_id * 2``, so boxes of different classes never overlap);
* the candidates are the ``top_k`` highest (prior, class) scores, put in
  ``lax.top_k``'s order: descending score, the lower flat index first
  among equal scores (``torch.topk`` promises no order among ties on
  CUDA). Scores under the threshold are zeroed first, so which zeros fill
  the tail of the candidate set is arbitrary — but a zero score never
  reaches the output: NMS starts with ``keep = score > 0``;
* the greedy suppression is ``top_k`` sequential steps over ``keep``
  ``[B, K]`` and the thresholded IoU ``[B, K, K]``;
* output is a fixed ``[B, max_detections, 6]`` tensor, rows
  ``(label, score, x1, y1, x2, y2)`` in score order, padded with label -1
  and score 0; each kept row is scattered to its rank, the rest to a sink
  row that is cut off (JAX's ``.at[rank].set(mode="drop")``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bbox import DEFAULT_VARIANCES, clip_boxes, decode_boxes, iou_matrix


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a fixed-size candidate set, batched over leading
    dims: boxes ``[..., K, 4]`` corner-form, scores ``[..., K]`` (0 for
    padded slots). Returns (keep ``[..., K]`` bool in sorted order, order
    ``[..., K]`` descending-score indices; stable, as ``jnp.argsort``)."""
    k = boxes.shape[-2]
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.gather(boxes, -2, order[..., None].expand_as(boxes))
    scores_s = torch.gather(scores, -1, order)
    idx = torch.arange(k, device=boxes.device)
    # over[..., i, j]: box i suppresses box j > i when i itself is kept
    over = (iou_matrix(boxes_s, boxes_s) > iou_threshold) & \
        (idx[None, :] > idx[:, None])
    keep = scores_s > 0.0
    for i in range(k):
        keep = keep & ~(over[..., i, :] & keep[..., i:i + 1])
    # enforce max_output: keep only the first max_output surviving slots
    kept_rank = torch.cumsum(keep.to(torch.int32), -1) - 1
    keep = keep & (kept_rank < max_output)
    return keep, order


def _top_k(flat: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equal values."""
    vals, idx = torch.topk(flat, k, dim=-1)
    by_idx = torch.argsort(idx, dim=-1)
    vals, idx = torch.gather(vals, -1, by_idx), torch.gather(idx, -1, by_idx)
    by_val = torch.argsort(-vals, dim=-1, stable=True)
    return torch.gather(vals, -1, by_val), torch.gather(idx, -1, by_val)


def decode_detections(loc: torch.Tensor, conf_logits: torch.Tensor,
                      priors, variances=DEFAULT_VARIANCES,
                      score_threshold: float = 0.05,
                      nms_threshold: float = 0.45,
                      top_k: int = 256,
                      max_detections: int = 100) -> torch.Tensor:
    """``[B, A, 4]`` loc + ``[B, A, C]`` logits -> ``[B, max_detections,
    6]`` detections ``(label, score, x1, y1, x2, y2)`` in normalized coords,
    padded with label -1 (DecodeOutput's (label, score, bbox) layout).
    ``priors`` is the center-form ``[A, 4]`` array (numpy or tensor)."""
    priors = torch.as_tensor(np.asarray(priors) if not isinstance(
        priors, torch.Tensor) else priors, dtype=loc.dtype,
        device=loc.device)
    b = loc.shape[0]
    boxes = clip_boxes(decode_boxes(loc, priors, variances))   # [B, A, 4]
    probs = torch.softmax(conf_logits, -1)[..., 1:]             # drop bg
    num_classes = probs.shape[-1]
    flat = probs.reshape(b, -1)                                 # [B, A*C']
    flat = torch.where(flat >= score_threshold, flat,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))
    cand_scores, cand_idx = _top_k(flat, int(top_k))
    prior_idx = cand_idx // num_classes
    cls_idx = cand_idx % num_classes                            # 0-based fg
    cand_boxes = torch.gather(boxes, 1, prior_idx[..., None].expand(
        -1, -1, 4))
    # batched-NMS trick: shift per class so cross-class IoU is 0
    shifted = cand_boxes + cls_idx[..., None].to(cand_boxes.dtype) * 2.0
    keep, order = nms(shifted, cand_scores, nms_threshold,
                      int(max_detections))
    boxes_o = torch.gather(cand_boxes, 1, order[..., None].expand(-1, -1, 4))
    scores_o = torch.gather(cand_scores, 1, order)
    labels_o = torch.gather(cls_idx, 1, order) + 1              # 1-based
    valid = keep & (scores_o > 0.0)
    rank = torch.where(valid, torch.cumsum(valid.to(torch.int64), -1) - 1,
                       torch.full_like(order, int(max_detections)))
    rows = torch.cat([labels_o[..., None].to(boxes.dtype),
                      scores_o[..., None], boxes_o], -1)        # [B, K, 6]
    out = torch.zeros((b, int(max_detections) + 1, 6), dtype=boxes.dtype,
                      device=boxes.device)
    out[..., 0] = -1.0
    # every valid row has its own rank; the rest share the sink row
    out.scatter_(1, rank[..., None].expand(-1, -1, 6), rows)
    return out[:, :int(max_detections)]


def scale_detections(dets, width: int, height: int):
    """Normalized detections -> pixel coords of the original image
    (Postprocessor.scala ScaleDetection)."""
    out = np.asarray(dets).copy()
    out[..., 2] *= width
    out[..., 4] *= width
    out[..., 3] *= height
    out[..., 5] *= height
    return out

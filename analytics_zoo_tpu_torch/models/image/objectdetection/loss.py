"""MultiBox loss — SSD training objective (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/loss.py``).

Reference: ``zoo/.../models/image/objectdetection/common/loss/``
(``MultiBoxLoss.scala``): match priors to ground truth by jaccard overlap,
smooth-L1 on matched localization offsets, cross-entropy with 3:1 hard
negative mining on confidences.

The JAX package ``vmap``s one image's loss over the batch; here matching
is one masked ``[B, M, A]`` IoU argmax, hard negative mining ranks each
image's negatives with a stable argsort, and the whole loss is batched
torch ops with static shapes. Ragged ground truth is padded to ``max_gt``
boxes with label 0 (0 = background/pad, 1..C-1 = foreground classes).

The bipartite pass makes every valid GT claim its best prior. When two GTs
claim the same prior, the JAX package's scatter keeps the later GT's write
(XLA's scatter runs its updates in order on the CPU); here the claim is an
``amax`` scatter-reduce over the GT index, the same answer on every
device (``index_put_`` with duplicate indices is undefined on CUDA).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bbox import (DEFAULT_VARIANCES, center_to_corner, encode_boxes,
                   iou_matrix)


def match_priors(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 priors_corner: torch.Tensor, iou_threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign each prior a GT box (or background), batched over leading
    dims.

    gt_boxes: ``[..., M, 4]`` corner-form, padded rows arbitrary
    gt_labels: ``[..., M]`` int, 0 for padded rows
    priors_corner: ``[A, 4]`` corner-form priors
    Returns (matched_labels ``[..., A]`` int64, matched_boxes ``[..., A,
    4]``).

    Per-prior best GT above the IoU threshold, plus every valid GT claims
    its single best prior regardless of threshold (the reference's
    bipartite pass) so no GT goes unmatched.
    """
    gt_labels = gt_labels.long()
    valid = gt_labels > 0                                   # [..., M]
    iou = iou_matrix(gt_boxes, priors_corner)               # [..., M, A]
    iou = torch.where(valid[..., None], iou,
                      torch.full((), -1.0, dtype=iou.dtype,
                                 device=iou.device))
    best_gt_iou = iou.amax(-2)                              # [..., A]
    best_gt = iou.argmax(-2)          # first maximum, as jnp.argmax
    best_prior = iou.argmax(-1)                             # [..., M]
    num_priors = priors_corner.shape[0]
    m = gt_labels.shape[-1]
    # bipartite pass: each valid GT claims its best prior (a padded GT
    # claims the sink slot A); the latest GT wins a shared prior
    slot = torch.where(valid, best_prior,
                       torch.full_like(best_prior, num_priors))
    gt_idx = torch.arange(m, device=slot.device).expand_as(slot)
    claim = torch.full(slot.shape[:-1] + (num_priors + 1,), -1,
                       dtype=torch.int64, device=slot.device)
    claim = claim.scatter_reduce(-1, slot, gt_idx, "amax")[..., :num_priors]
    claimed = claim >= 0
    best_gt = torch.where(claimed, claim, best_gt)
    best_gt_iou = torch.where(claimed, torch.full((), 2.0,
                                                  dtype=iou.dtype,
                                                  device=iou.device),
                              best_gt_iou)
    matched_labels = torch.where(best_gt_iou >= iou_threshold,
                                 torch.gather(gt_labels, -1, best_gt),
                                 torch.zeros_like(best_gt))
    matched_boxes = torch.gather(
        gt_boxes, -2, best_gt[..., None].expand(best_gt.shape + (4,)))
    return matched_labels, matched_boxes


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def multibox_loss(priors, variances=DEFAULT_VARIANCES,
                  neg_pos_ratio: int = 3, iou_threshold: float = 0.5):
    """Build the estimator-compatible loss: (y_true, y_pred) -> [B] losses.

    ``y_true`` = (gt_boxes [B, M, 4], gt_labels [B, M]) or the packed
    ``[B, M, 5]`` array ``(x1, y1, x2, y2, label)``;
    ``y_pred`` = (loc [B, A, 4], conf_logits [B, A, C]) from the SSD head.
    ``priors`` is the constant center-form [A, 4] prior set.
    """
    priors_np = np.asarray(priors, np.float32)
    cache = {}

    def consts(device):
        if device not in cache:
            p = torch.from_numpy(priors_np).to(device)
            cache[device] = (p, center_to_corner(p))
        return cache[device]

    def loss_fn(y_true, y_pred):
        if isinstance(y_true, (list, tuple)):
            gt_boxes, gt_labels = y_true[0], y_true[1]
        else:
            gt_boxes, gt_labels = y_true[..., :4], y_true[..., 4]
        gt_labels = gt_labels.to(torch.int32).long()
        loc_pred, conf_logits = y_pred
        priors_center, priors_corner = consts(loc_pred.device)
        labels, boxes = match_priors(gt_boxes, gt_labels, priors_corner,
                                     iou_threshold)
        pos = labels > 0                                    # [B, A]
        num_pos = pos.sum(-1)

        # localization: smooth-L1 on positives against encoded targets
        targets = encode_boxes(boxes, priors_center, variances)
        loc_l = _smooth_l1(loc_pred - targets).sum(-1)
        zero = torch.zeros((), dtype=loc_l.dtype, device=loc_l.device)
        loc_loss = torch.where(pos, loc_l, zero).sum(-1)

        # confidence: CE everywhere; hard negative mining keeps the
        # neg_pos_ratio * num_pos highest-loss background priors
        logp = torch.log_softmax(conf_logits, -1)
        ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
        neg_score = torch.where(pos, torch.full_like(ce, -np.inf),
                                ce.detach())
        order = torch.argsort(-neg_score, dim=-1, stable=True)
        # rank[a] = position of prior a in descending order (the inverse
        # permutation of order)
        rank = torch.empty_like(order).scatter_(
            -1, order, torch.arange(order.shape[-1], device=order.device)
            .expand_as(order))
        num_neg = torch.minimum(neg_pos_ratio * num_pos, (~pos).sum(-1))
        neg = rank < num_neg[..., None]
        conf_loss = torch.where(pos | neg, ce, zero).sum(-1)

        denom = num_pos.to(loc_pred.dtype).clamp_min(1.0)
        return (loc_loss + conf_loss) / denom

    return loss_fn

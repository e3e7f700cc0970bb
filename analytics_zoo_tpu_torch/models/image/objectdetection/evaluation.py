"""Detection evaluation — VOC-style mean average precision (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/evaluation.py``, the same
numpy code).

Reference: the SSD validation path computes MeanAveragePrecision
(zoo/.../models/image/objectdetection + BigDL's MAPValidationResult; the
PASCAL-VOC protocol). Host-side numpy: evaluation is once-per-epoch over
decoded detections, not a hot loop, so clarity wins over jit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU between (N,4) and (M,4) corner-form boxes -> (N, M)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), axis=-1)
    area_a = np.prod(np.clip(a[:, 2:] - a[:, :2], 0, None), axis=-1)
    area_b = np.prod(np.clip(b[:, 2:] - b[:, :2], 0, None), axis=-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-12)).astype(np.float32)


def _average_precision(recall: np.ndarray, precision: np.ndarray,
                       use_07_metric: bool = False) -> float:
    """AP from a PR curve: 11-point (VOC2007) or all-points interpolation."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            mask = recall >= t
            ap += (float(precision[mask].max()) if mask.any() else 0.0) / 11
        return ap
    r = np.concatenate([[0.0], recall, [1.0]])
    p = np.concatenate([[0.0], precision, [0.0]])
    p = np.maximum.accumulate(p[::-1])[::-1]       # envelope
    idx = np.where(r[1:] != r[:-1])[0]
    return float(np.sum((r[idx + 1] - r[idx]) * p[idx + 1]))


def voc_detection_map(detections: Sequence[np.ndarray],
                      gt_boxes: Sequence[np.ndarray],
                      gt_labels: Sequence[np.ndarray],
                      num_classes: int,
                      iou_threshold: float = 0.5,
                      use_07_metric: bool = False) -> Dict:
    """PASCAL-VOC mAP.

    detections: per image, (N, 6) rows [class_id, score, x1, y1, x2, y2]
        (the layout ObjectDetector.predict_image_set emits; padded rows with
        score <= 0 are ignored). Class ids are 1-based (0 = background).
    gt_boxes / gt_labels: per image, (M, 4) corner boxes and (M,) 1-based
        class ids.
    Returns {"mAP": float, "ap_per_class": {class_id: ap}}.
    """
    aps: Dict[int, float] = {}
    for cls in range(1, num_classes):
        # flatten this class's detections over the corpus
        recs: List = []    # (image_idx, score, box)
        n_gt = 0
        gt_by_img = []
        for i, (boxes, labels) in enumerate(zip(gt_boxes, gt_labels)):
            boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
            labels = np.asarray(labels).reshape(-1)
            sel = boxes[labels == cls]
            gt_by_img.append(sel)
            n_gt += len(sel)
        for i, det in enumerate(detections):
            det = np.asarray(det, np.float32).reshape(-1, 6)
            det = det[(det[:, 0] == cls) & (det[:, 1] > 0)]
            for row in det:
                recs.append((i, float(row[1]), row[2:6]))
        if n_gt == 0:
            continue                        # class absent from ground truth
        if not recs:
            aps[cls] = 0.0
            continue
        recs.sort(key=lambda r: -r[1])
        matched = [np.zeros(len(g), bool) for g in gt_by_img]
        tp = np.zeros(len(recs))
        fp = np.zeros(len(recs))
        for k, (img, _score, box) in enumerate(recs):
            gts = gt_by_img[img]
            ious = _iou_matrix(box[None], gts)[0] if len(gts) else \
                np.zeros(0)
            best = int(np.argmax(ious)) if len(ious) else -1
            if best >= 0 and ious[best] >= iou_threshold \
                    and not matched[img][best]:
                matched[img][best] = True
                tp[k] = 1
            else:
                fp[k] = 1
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        aps[cls] = _average_precision(recall, precision, use_07_metric)
    return {"mAP": float(np.mean(list(aps.values()))) if aps else 0.0,
            "ap_per_class": aps}

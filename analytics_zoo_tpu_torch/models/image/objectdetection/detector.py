"""ObjectDetector model-zoo API + label maps + visualizer (counterpart of
``analytics_zoo_tpu/models/image/objectdetection/detector.py``).

Reference surface: ``pyzoo/zoo/models/image/objectdetection/object_detector.py``
(ObjectDetector.load_model / predict_image_set, read_pascal_label_map,
read_coco_label_map, Visualizer) backed by Scala
``models/image/objectdetection/ObjectDetector.scala`` + ``Visualizer.scala``.

The detector is an SSD module trained by the port's ``TPUEstimator`` with
the multibox loss; prediction runs the batched decode + NMS postprocessor
on the estimator's device. :meth:`ObjectDetector.as_inference_model` wraps
a copy of the trained SSD and the postprocessor in one module
(:class:`SSDServable`), the unit ``ClusterServing`` serves. The estimator,
and so the detector, runs on ``cuda`` unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...common.initializers import as_torch_dtype
from ...common.zoo_model import ZooModel
from .loss import multibox_loss
from .postprocess import decode_detections, scale_detections
from .ssd import SSD, ssd_300, ssd_tiny

PASCAL_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush")


def read_pascal_label_map() -> dict:
    """label -> 1-based index (reference: readPascalLabelMap via LabelReader)."""
    return {name: i + 1 for i, name in enumerate(PASCAL_CLASSES)}


def read_coco_label_map() -> dict:
    return {name: i + 1 for i, name in enumerate(COCO_CLASSES)}


class SSDServable(SSD):
    """The served detector: an SSD whose ``forward(x [B, H, W, 3])`` runs
    the trunk in ``serve_dtype``, then box decode and NMS in f32, and
    returns ``[B, max_detections, 6]`` rows ``(label, score, x1, y1, x2,
    y2)``, normalized coords. Its ``state_dict`` is the SSD's, so a
    checkpoint of the bare SSD, of either package, loads into it as it
    is."""

    def __init__(self, num_classes: int, image_size: int = 300,
                 specs: Sequence = (), base_width: int = 64,
                 max_width: int = 512, score_threshold: float = 0.05,
                 nms_threshold: float = 0.45, max_detections: int = 100,
                 serve_dtype="float32"):
        super().__init__(num_classes, image_size, specs, base_width,
                         max_width)
        self.score_threshold = float(score_threshold)
        self.nms_threshold = float(nms_threshold)
        self.max_detections = int(max_detections)
        self.serve_dtype = as_torch_dtype(serve_dtype)
        self.register_buffer("prior_boxes",
                             torch.from_numpy(self.priors()),
                             persistent=False)

    @classmethod
    def of(cls, ssd: SSD, **kwargs) -> "SSDServable":
        """A servable on the CPU holding a copy of ``ssd``'s weights;
        ``kwargs`` are the postprocessor's and ``serve_dtype``."""
        servable = cls.from_config({**ssd.config, **kwargs})
        servable.load_state_dict(ssd.state_dict())
        return servable.eval()

    @property
    def config(self) -> Dict[str, Any]:
        return {**super().config,
                "score_threshold": self.score_threshold,
                "nms_threshold": self.nms_threshold,
                "max_detections": self.max_detections,
                "serve_dtype": str(self.serve_dtype).replace("torch.", "")}

    def trunk(self, x: torch.Tensor):
        """(loc, conf) of the SSD run in ``serve_dtype``."""
        return super().forward(x.to(self.serve_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        loc, conf = self.trunk(x)
        return decode_detections(
            loc.float(), conf.float(), self.prior_boxes,
            score_threshold=self.score_threshold,
            nms_threshold=self.nms_threshold,
            max_detections=self.max_detections)


class ObjectDetector(ZooModel):
    """SSD object detector with the reference's model-zoo surface."""

    def __init__(self, class_names: Sequence[str] = PASCAL_CLASSES,
                 image_size: int = 300, model_type: str = "ssd300",
                 max_gt: int = 32, device=None, **net_kwargs):
        self.class_names = tuple(class_names)
        self.image_size = int(image_size)
        self.model_type = model_type
        self.max_gt = int(max_gt)
        self._net_kwargs = dict(net_kwargs)
        num_classes = len(self.class_names) + 1      # + background
        if model_type == "ssd300":
            module = ssd_300(num_classes, **net_kwargs)
        elif model_type == "ssd_tiny":
            module = ssd_tiny(num_classes, image_size=image_size,
                              **net_kwargs)
        elif model_type == "ssd_mobilenet_v2":
            raise NotImplementedError(
                "ssd_mobilenet_v2 needs the MobileNetV2 backbone of "
                "models/image/imageclassification, which is not ported yet")
        else:
            raise ValueError(f"unknown model_type {model_type!r} "
                             "(known: ssd300, ssd_tiny, ssd_mobilenet_v2)")
        super().__init__(module, device=device)
        self.priors = module.priors()

    # --- training -----------------------------------------------------------
    def compile(self, loss=None, optimizer="adam", metrics=None, **kwargs):
        if loss is None:
            loss = multibox_loss(self.priors)
        return super().compile(loss=loss, optimizer=optimizer,
                               metrics=metrics, **kwargs)

    @staticmethod
    def pack_targets(boxes_list: Sequence[np.ndarray],
                     labels_list: Sequence[np.ndarray],
                     max_gt: int) -> np.ndarray:
        """Ragged per-image (boxes [m,4], labels [m]) -> padded [B, max_gt, 5]
        (x1,y1,x2,y2,label); pad rows have label 0. The static-shape analogue
        of the reference's SSDMiniBatch roi tensors."""
        b = len(boxes_list)
        out = np.zeros((b, max_gt, 5), dtype=np.float32)
        for i, (bx, lb) in enumerate(zip(boxes_list, labels_list)):
            m = min(len(lb), max_gt)
            if m:
                out[i, :m, :4] = np.asarray(bx, dtype=np.float32)[:m]
                out[i, :m, 4] = np.asarray(lb, dtype=np.float32)[:m]
        return out

    # --- inference ----------------------------------------------------------
    def predict_image_set(self, image_set, score_threshold: float = 0.05,
                          nms_threshold: float = 0.45,
                          max_detections: int = 100,
                          batch_size: int = 32,
                          original_sizes: Optional[List] = None):
        """ndarray ``[B, H, W, 3]`` -> ``[B, max_detections, 6]`` (label,
        score, box).

        Boxes come back in pixel coords of the *input* images (the
        reference's ScaleDetection step); pass ``original_sizes`` as a list of
        (height, width) to rescale to pre-resize frames instead.
        """
        if not isinstance(image_set, (np.ndarray, list, tuple)):
            raise NotImplementedError(
                "ImageSet input needs feature/image (queue A8), which is "
                "not ported yet; pass an ndarray of images")
        imgs = np.asarray(image_set)
        loc, conf = self.predict(imgs, batch_size=batch_size)
        dev = self.estimator.device
        with torch.no_grad():
            dets = decode_detections(
                torch.from_numpy(loc).to(dev), torch.from_numpy(conf).to(dev),
                self.priors, score_threshold=score_threshold,
                nms_threshold=nms_threshold,
                max_detections=max_detections).cpu().numpy()
        if original_sizes is None:
            h = w = self.image_size
            return scale_detections(dets, w, h)
        out = np.empty_like(dets)
        for i, (h, w) in enumerate(original_sizes):
            out[i] = scale_detections(dets[i], w, h)
        return out

    def evaluate_map(self, images, gt_boxes, gt_labels,
                     iou_threshold: float = 0.5, use_07_metric: bool = False,
                     score_threshold: float = 0.05, **predict_kwargs):
        """PASCAL-VOC mean average precision over a labeled image set
        (reference validation metric: MeanAveragePrecision). ``gt_boxes``
        are normalized [0,1] corner boxes (the training-target convention);
        ``gt_labels`` 1-based class ids. Returns {"mAP", "ap_per_class"}."""
        from .evaluation import voc_detection_map
        if predict_kwargs.get("original_sizes") is not None:
            raise ValueError(
                "evaluate_map scales ground truth by the model input size; "
                "rescaling detections to per-image original_sizes would "
                "silently corrupt the mAP. Evaluate in input-frame coords "
                "(drop original_sizes), or rescale both sides yourself and "
                "call voc_detection_map directly.")
        dets = self.predict_image_set(images,
                                      score_threshold=score_threshold,
                                      **predict_kwargs)
        scale = float(self.image_size)
        gt_px = [np.asarray(b, np.float32).reshape(-1, 4) * scale
                 for b in gt_boxes]
        return voc_detection_map(
            list(dets), gt_px, list(gt_labels),
            num_classes=len(self.class_names) + 1,
            iou_threshold=iou_threshold, use_07_metric=use_07_metric)

    def as_inference_model(self, score_threshold: float = 0.05,
                           nms_threshold: float = 0.45,
                           max_detections: int = 100,
                           serve_dtype=None):
        """An :class:`~analytics_zoo_tpu_torch.pipeline.inference.
        InferenceModel` on the estimator's device, serving a copy of the
        trained detector as an :class:`SSDServable`, whose ``predict``
        returns decoded (label, score, box) detections — the unit
        ClusterServing serves (BASELINE config #5: object-detection
        serving).

        ``serve_dtype``: compute dtype of the conv trunk; None means bf16
        on ``cuda`` (serving ingress sends f32 images, which would
        otherwise run the trunk at the f32 rate) and f32 on the CPU. Box
        decode and NMS stay f32."""
        from ....pipeline.inference.inference_model import InferenceModel

        device = self.estimator.device
        if serve_dtype is None:
            serve_dtype = torch.bfloat16 if device.type == "cuda" \
                else torch.float32
        servable = SSDServable.of(
            self.module, score_threshold=score_threshold,
            nms_threshold=nms_threshold, max_detections=max_detections,
            serve_dtype=serve_dtype)
        return InferenceModel(device=device).load_module(servable)

    # --- persistence --------------------------------------------------------
    def save_model(self, path: str, over_write: bool = False):
        """The detector's config and engine state, as plain values with
        ``torch.save``."""
        if os.path.exists(path) and not over_write:
            raise FileExistsError(path)
        torch.save({
            "cls": "ObjectDetector",
            "cfg": {"class_names": list(self.class_names),
                    "image_size": self.image_size,
                    "model_type": self.model_type,
                    "max_gt": self.max_gt,
                    "net_kwargs": self._net_kwargs},
            "state": self.estimator.engine.get_state(),
        }, path)
        return path

    @classmethod
    def load_model(cls, path: str, weight_path: Optional[str] = None,
                   device=None):
        """(reference: ObjectDetector.load_model — weight_path kept for
        source compatibility; the one file carries the weights)."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        cfg = blob["cfg"]
        model = cls(class_names=cfg["class_names"],
                    image_size=cfg["image_size"],
                    model_type=cfg["model_type"], max_gt=cfg["max_gt"],
                    device=device, **cfg.get("net_kwargs", {}))
        model.compile()
        model.estimator.engine.set_state(blob["state"])
        return model


class Visualizer:
    """Draw detection boxes into an image array (reference:
    models/image/objectdetection/Visualizer.scala — rendered rectangles +
    labels; here: pure-numpy rectangle outlines, no font rendering)."""

    def __init__(self, class_names: Sequence[str] = PASCAL_CLASSES,
                 thresh: float = 0.3, line: int = 2):
        self.class_names = tuple(class_names)
        self.thresh = thresh
        self.line = line

    def visualize(self, image: np.ndarray, detections: np.ndarray
                  ) -> np.ndarray:
        img = np.array(image, copy=True)
        h, w = img.shape[:2]
        color = np.asarray([255, 64, 64], dtype=img.dtype)[:img.shape[-1]] \
            if img.ndim == 3 else 255
        for det in detections:
            label, score = det[0], det[1]
            if label < 0 or score < self.thresh:
                continue
            x1, y1, x2, y2 = det[2:6]
            x1 = int(np.clip(x1, 0, w - 1)); x2 = int(np.clip(x2, 0, w - 1))
            y1 = int(np.clip(y1, 0, h - 1)); y2 = int(np.clip(y2, 0, h - 1))
            t = self.line
            img[y1:y1 + t, x1:x2 + 1] = color
            img[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = color
            img[y1:y2 + 1, x1:x1 + t] = color
            img[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = color
        return img

"""Object detection stack (counterpart of ``analytics_zoo_tpu/models/image/
objectdetection``; reference: ``zoo/.../models/image/objectdetection/`` —
SSD graphs, BboxUtil, MultiBoxLoss, Postprocessor, ObjectDetector,
Visualizer). ``SSDMobileNetV2`` waits for the image-classification
families (queue A9)."""

from .bbox import (DEFAULT_VARIANCES, center_to_corner, clip_boxes,
                   corner_to_center, decode_boxes, encode_boxes, iou_matrix)
from .detector import (COCO_CLASSES, PASCAL_CLASSES, ObjectDetector,
                       SSDServable, Visualizer, read_coco_label_map,
                       read_pascal_label_map)
from .evaluation import voc_detection_map
from .interop import load_flax_ssd, ssd_to_flax
from .loss import match_priors, multibox_loss
from .postprocess import decode_detections, nms, scale_detections
from .priors import PriorSpec, generate_priors, ssd300_specs, tiny_specs
from .ssd import SSD, ssd_300, ssd_tiny

__all__ = [
    "DEFAULT_VARIANCES", "center_to_corner", "corner_to_center",
    "clip_boxes", "decode_boxes", "encode_boxes", "iou_matrix",
    "match_priors", "multibox_loss", "decode_detections", "nms",
    "scale_detections", "PriorSpec", "generate_priors", "ssd300_specs",
    "tiny_specs", "SSD", "ssd_300", "ssd_tiny", "ObjectDetector",
    "SSDServable", "voc_detection_map", "Visualizer",
    "read_pascal_label_map", "read_coco_label_map", "PASCAL_CLASSES",
    "COCO_CLASSES", "load_flax_ssd", "ssd_to_flax",
]

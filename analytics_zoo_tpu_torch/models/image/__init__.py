"""Image models (counterpart of ``analytics_zoo_tpu/models/image``): the
ResNet family here, the classifier families and ``ImageClassifier`` in
``imageclassification``, the SSD detectors and ``ObjectDetector`` in
``objectdetection``."""

from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152, resnet)

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "resnet"]

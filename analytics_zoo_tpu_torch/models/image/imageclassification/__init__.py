from .families import (AlexNet, DenseNet121, MobileNetV1, MobileNetV2,
                       SqueezeNet, VGG, VGG16, VGG19)
from .classifier import (IMAGENET_TOP_CONFIGS, ImageClassifier,
                         LabelOutput)
from .inception import InceptionV1

__all__ = ["ImageClassifier", "InceptionV1", "LabelOutput",
           "IMAGENET_TOP_CONFIGS"]

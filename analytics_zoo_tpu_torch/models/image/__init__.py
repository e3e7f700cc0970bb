from .resnet import (ResNet, ResNet18, ResNet34, ResNet50, ResNet101,
                     ResNet152, resnet)

__all__ = ["ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101",
           "ResNet152", "resnet"]

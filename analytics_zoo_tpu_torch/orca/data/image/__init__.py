from .imagenet import (IMAGENET_MEAN, IMAGENET_STD, ImageNetPipeline,
                       write_synthetic_imagenet)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ImageNetPipeline",
           "write_synthetic_imagenet"]

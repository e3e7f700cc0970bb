"""Image inputs (counterpart of ``analytics_zoo_tpu/feature/image``):
``ImageSet`` and the host transforms, with the decoders of ``codecs``
(PNG and BMP on the host, JPEG on the card through nvJPEG) in place of
cv2."""

from .imageset import ImageSet
from .preprocessing import (ChainedPreprocessing, ImageAspectScale,
                            ImageBrightness, ImageBytesToMat,
                            ImageCenterCrop, ImageChannelNormalize,
                            ImageChannelOrder, ImageColorJitter, ImageExpand,
                            ImageFiller, ImageFixedCrop, ImageHFlip,
                            ImageHue, ImageMatToTensor, ImageMirror,
                            ImagePixelNormalizer, ImageRandomAspectScale,
                            ImageRandomCrop, ImageRandomPreprocessing,
                            ImageResize, ImageSaturation, ImageSetToSample,
                            PerImageNormalize, Preprocessing,
                            imagenet_train_transforms,
                            imagenet_val_transforms)

__all__ = ["ImageSet", "Preprocessing", "ChainedPreprocessing", "ImageResize",
           "ImageAspectScale", "ImageRandomAspectScale", "ImageCenterCrop",
           "ImageRandomCrop", "ImageFixedCrop", "ImageHFlip", "ImageMirror",
           "ImageChannelNormalize", "ImagePixelNormalizer",
           "PerImageNormalize", "ImageBrightness", "ImageSaturation",
           "ImageHue", "ImageColorJitter", "ImageChannelOrder",
           "ImageBytesToMat", "ImageExpand", "ImageFiller",
           "ImageRandomPreprocessing", "ImageMatToTensor", "ImageSetToSample",
           "imagenet_train_transforms", "imagenet_val_transforms"]

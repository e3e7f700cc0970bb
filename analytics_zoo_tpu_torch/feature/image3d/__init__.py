from .transformation import (AffineTransform3D, CenterCrop3D, Crop3D,
                             ImagePreprocessing3D, RandomCrop3D, Rotate3D)

"""Feature engineering (counterpart of ``analytics_zoo_tpu/feature``): the
FeatureSet cache tiers, the text input (``feature.text``) and the image
inputs (``feature.image``, ``feature.image3d``)."""

from .feature_set import DiskFeatureSet, FeatureSet

__all__ = ["FeatureSet", "DiskFeatureSet"]

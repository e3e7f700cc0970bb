"""Feature engineering (counterpart of ``analytics_zoo_tpu/feature``): the
FeatureSet cache tiers, and the text input (``feature.text``). The image
input is not ported yet (ROADMAP A8)."""

from .feature_set import DiskFeatureSet, FeatureSet

__all__ = ["FeatureSet", "DiskFeatureSet"]

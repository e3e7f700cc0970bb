"""Friesian, recsys feature engineering on the host (counterpart of
``analytics_zoo_tpu/friesian``): ``FeatureTable`` and ``StringIndex`` in
``friesian.feature``."""

from .feature import FeatureTable, StringIndex, Table

__all__ = ["FeatureTable", "StringIndex", "Table"]

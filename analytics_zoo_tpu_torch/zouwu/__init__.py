"""Zouwu time series (counterpart of ``analytics_zoo_tpu/zouwu``): the
forecaster family with TCMF for high-dimensional panels, anomaly
detectors, recipes, the feature transformer and AutoTS."""

from .model.forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                             Seq2SeqForecaster, TCNForecaster)
from .model.tcmf import TCMF, TCMFForecaster

__all__ = ["Forecaster", "LSTMForecaster", "TCNForecaster",
           "Seq2SeqForecaster", "MTNetForecaster", "TCMF", "TCMFForecaster"]

"""Zouwu time series (counterpart of ``analytics_zoo_tpu/zouwu``): the
forecaster family, anomaly detectors, recipes, the feature transformer
and AutoTS. TCMF is not ported yet (ROADMAP A5)."""

from .model.forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                             Seq2SeqForecaster, TCNForecaster)

__all__ = ["Forecaster", "LSTMForecaster", "TCNForecaster",
           "Seq2SeqForecaster", "MTNetForecaster"]

from .forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                       Seq2SeqForecaster, TCNForecaster)
from .anomaly import AEDetector, DBScanDetector, ThresholdDetector

__all__ = ["Forecaster", "LSTMForecaster", "TCNForecaster",
           "Seq2SeqForecaster", "MTNetForecaster", "ThresholdDetector",
           "AEDetector", "DBScanDetector"]

from .forecast import (Forecaster, LSTMForecaster, MTNetForecaster,
                       Seq2SeqForecaster, TCNForecaster)
from .anomaly import AEDetector, DBScanDetector, ThresholdDetector
from .tcmf import TCMF, TCMFForecaster

__all__ = ["Forecaster", "LSTMForecaster", "TCNForecaster",
           "Seq2SeqForecaster", "MTNetForecaster", "TCMF", "TCMFForecaster",
           "ThresholdDetector", "AEDetector", "DBScanDetector"]

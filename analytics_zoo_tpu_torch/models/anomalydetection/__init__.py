from .anomaly_detector import AnomalyDetector, AnomalyDetectorNet

__all__ = ["AnomalyDetector", "AnomalyDetectorNet"]

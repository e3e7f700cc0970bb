from .estimator import Estimator, TPUEstimator

__all__ = ["Estimator", "TPUEstimator"]

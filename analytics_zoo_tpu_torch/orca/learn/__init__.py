from .estimator import TPUEstimator

__all__ = ["TPUEstimator"]

from .estimator import Estimator, PyTorchTPUEstimator
from .training_operator import TrainingOperator

__all__ = ["Estimator", "PyTorchTPUEstimator", "TrainingOperator"]

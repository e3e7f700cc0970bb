from .estimator import Estimator

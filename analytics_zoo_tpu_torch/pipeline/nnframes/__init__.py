from .nn_classifier import (NNClassifier, NNClassifierModel, NNEstimator,
                            NNModel)
from .nn_image_reader import NNImageReader

__all__ = ["NNClassifier", "NNClassifierModel", "NNEstimator", "NNModel",
           "NNImageReader"]

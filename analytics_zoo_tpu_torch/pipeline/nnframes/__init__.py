from .nn_classifier import (NNClassifier, NNClassifierModel, NNEstimator,
                            NNModel)

__all__ = ["NNClassifier", "NNClassifierModel", "NNEstimator", "NNModel"]

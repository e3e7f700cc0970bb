from .neuralcf import NeuralCF, NeuralCFNet

__all__ = ["NeuralCF", "NeuralCFNet"]

"""keras2 layer namespace (counterpart of ``analytics_zoo_tpu/pipeline/
api/keras2/layers``): tf.keras-style factories over the Keras v1 layers."""

from .advanced_activations import ELU, LeakyReLU, PReLU, ThresholdedReLU
from .convolutional import Conv1D, Conv2D, Cropping1D
from .convolutional_recurrent import ConvLSTM2D
from .core import Activation, Dense, Dropout, Flatten
from .embeddings import Embedding
from .local import LocallyConnected1D
from .merge import Average, Maximum, Minimum, average, maximum, minimum
from .noise import GaussianDropout, GaussianNoise
from .normalization import BatchNormalization
from .pooling import (AveragePooling1D, GlobalAveragePooling1D,
                      GlobalAveragePooling2D, GlobalMaxPooling1D,
                      MaxPooling1D)
from .recurrent import GRU, LSTM, SimpleRNN
from .wrappers import Bidirectional, TimeDistributed

__all__ = [
    "Conv1D", "Conv2D", "Cropping1D", "ConvLSTM2D",
    "Activation", "Dense", "Dropout", "Flatten",
    "LocallyConnected1D",
    "Average", "Maximum", "Minimum", "average", "maximum", "minimum",
    "AveragePooling1D", "GlobalAveragePooling1D", "GlobalAveragePooling2D",
    "GlobalMaxPooling1D", "MaxPooling1D",
    "LSTM", "GRU", "SimpleRNN",
    "Embedding", "BatchNormalization",
    "LeakyReLU", "ELU", "PReLU", "ThresholdedReLU",
    "GaussianNoise", "GaussianDropout",
    "TimeDistributed", "Bidirectional",
]

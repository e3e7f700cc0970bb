from .advanced_activations import (ELU, LeakyReLU, PReLU, RReLU, SReLU,
                                   ThresholdedReLU)
from .convolutional import (AtrousConvolution1D, AtrousConvolution2D,
                            Convolution1D, Convolution2D, Convolution3D,
                            Cropping1D, Cropping2D, Cropping3D,
                            Deconvolution2D, LocallyConnected1D,
                            LocallyConnected2D, SeparableConvolution2D,
                            ShareConvolution2D, UpSampling1D, UpSampling2D,
                            UpSampling3D, ZeroPadding1D, ZeroPadding2D,
                            ZeroPadding3D)
from .core import (Activation, AddConstant, BinaryThreshold, CAdd, CMul,
                   Dense, Dropout, Exp, ExpandDim, Flatten, GaussianSampler,
                   GetShape, HardShrink, HardTanh, Highway, Identity, Log,
                   Masking, MaxoutDense, Merge, Mul, MulConstant, Narrow,
                   Negative, Permute, Power, RepeatVector, Reshape,
                   ResizeBilinear, Scale, Select, SoftShrink, SparseDense,
                   Sqrt, Square, Squeeze, Threshold, merge)
from .embeddings import Embedding, SparseEmbedding, WordEmbedding
from .noise import (GaussianDropout, GaussianNoise, SpatialDropout1D,
                    SpatialDropout2D, SpatialDropout3D)
from .normalization import (BatchNormalization, LayerNormalization, LRN2D,
                            WithinChannelLRN2D)
from .pooling import (AveragePooling1D, AveragePooling2D, AveragePooling3D,
                      GlobalAveragePooling1D, GlobalAveragePooling2D,
                      GlobalAveragePooling3D, GlobalMaxPooling1D,
                      GlobalMaxPooling2D, GlobalMaxPooling3D, MaxPooling1D,
                      MaxPooling2D, MaxPooling3D)
from .recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D, SimpleRNN,
                        TimeDistributed)
from .self_attention import (BERT, MultiHeadAttention, TransformerBlock,
                             TransformerLayer)

# Keras 2-style aliases, as the JAX package defines them
Conv1D = Convolution1D
Conv2D = Convolution2D
Conv3D = Convolution3D
Conv2DTranspose = Deconvolution2D
SeparableConv2D = SeparableConvolution2D

__all__ = [
    "Activation", "AddConstant", "BinaryThreshold", "CAdd", "CMul", "Dense",
    "Dropout", "Exp", "ExpandDim", "Flatten", "GaussianSampler", "GetShape",
    "HardShrink", "HardTanh", "Highway", "Identity", "Log", "Masking",
    "MaxoutDense", "Merge", "Mul", "MulConstant", "Narrow", "Negative",
    "Permute", "Power", "RepeatVector", "Reshape", "ResizeBilinear", "Scale",
    "Select", "SoftShrink", "SparseDense", "Sqrt", "Square", "Squeeze",
    "Threshold", "merge",
    "BatchNormalization", "LayerNormalization", "LRN2D",
    "WithinChannelLRN2D",
    "GaussianDropout", "GaussianNoise", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D",
    "ELU", "LeakyReLU", "PReLU", "RReLU", "SReLU", "ThresholdedReLU",
    "BERT", "MultiHeadAttention", "TransformerBlock", "TransformerLayer",
    "AtrousConvolution1D", "AtrousConvolution2D", "Convolution1D",
    "Convolution2D", "Convolution3D", "Cropping1D", "Cropping2D",
    "Cropping3D", "Deconvolution2D", "LocallyConnected1D",
    "LocallyConnected2D", "SeparableConvolution2D", "ShareConvolution2D",
    "UpSampling1D", "UpSampling2D", "UpSampling3D", "ZeroPadding1D",
    "ZeroPadding2D", "ZeroPadding3D",
    "AveragePooling1D", "AveragePooling2D", "AveragePooling3D",
    "GlobalAveragePooling1D", "GlobalAveragePooling2D",
    "GlobalAveragePooling3D", "GlobalMaxPooling1D", "GlobalMaxPooling2D",
    "GlobalMaxPooling3D", "MaxPooling1D", "MaxPooling2D", "MaxPooling3D",
    "Bidirectional", "ConvLSTM2D", "GRU", "LSTM", "SimpleRNN",
    "TimeDistributed", "Embedding", "SparseEmbedding", "WordEmbedding",
    "Conv1D", "Conv2D", "Conv3D", "Conv2DTranspose", "SeparableConv2D"]

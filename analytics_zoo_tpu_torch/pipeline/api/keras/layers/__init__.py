from .advanced_activations import (ELU, LeakyReLU, PReLU, RReLU, SReLU,
                                   ThresholdedReLU)
from .core import (Activation, AddConstant, BinaryThreshold, CAdd, CMul,
                   Dense, Dropout, Exp, ExpandDim, Flatten, GaussianSampler,
                   GetShape, HardShrink, HardTanh, Highway, Identity, Log,
                   Masking, MaxoutDense, Merge, Mul, MulConstant, Narrow,
                   Negative, Permute, Power, RepeatVector, Reshape,
                   ResizeBilinear, Scale, Select, SoftShrink, SparseDense,
                   Sqrt, Square, Squeeze, Threshold, merge)
from .noise import (GaussianDropout, GaussianNoise, SpatialDropout1D,
                    SpatialDropout2D, SpatialDropout3D)
from .normalization import (BatchNormalization, LayerNormalization, LRN2D,
                            WithinChannelLRN2D)
from .self_attention import (BERT, MultiHeadAttention, TransformerBlock,
                             TransformerLayer)

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
    "BERT", "MultiHeadAttention", "TransformerBlock", "TransformerLayer"]

"""keras2 locally-connected layer (counterpart of ``analytics_zoo_tpu/
pipeline/api/keras2/layers/local.py``): ``LocallyConnected1D(filters,
kernel_size, strides)`` over v1's; only ``padding="valid"``, as in the
JAX package."""

from __future__ import annotations

from ...keras import layers as K1
from .convolutional import _first

__all__ = ["LocallyConnected1D"]


def LocallyConnected1D(filters, kernel_size, strides=1, padding="valid",
                       activation=None, kernel_regularizer=None,
                       bias_regularizer=None, use_bias=True,
                       input_shape=None, **kwargs):
    if padding != "valid":
        raise ValueError("For LocallyConnected1D, only padding='valid' is "
                         "supported for now")
    del kernel_regularizer, bias_regularizer
    return K1.LocallyConnected1D(
        nb_filter=int(filters), filter_length=int(_first(kernel_size)),
        activation=activation, subsample_length=int(_first(strides)),
        use_bias=use_bias,
        input_shape=tuple(input_shape) if input_shape else None, **kwargs)

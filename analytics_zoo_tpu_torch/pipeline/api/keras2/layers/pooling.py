"""keras2 pooling layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/pooling.py``): ``pool_size``/``strides``/``padding`` over
the v1 pooling layers."""

from __future__ import annotations

from ...keras import layers as K1

__all__ = ["MaxPooling1D", "AveragePooling1D", "GlobalMaxPooling1D",
           "GlobalAveragePooling1D", "GlobalAveragePooling2D"]


def _shape(input_shape):
    return tuple(input_shape) if input_shape else None


def MaxPooling1D(pool_size=2, strides=None, padding="valid",
                 input_shape=None, **kwargs):
    return K1.MaxPooling1D(pool_length=int(pool_size),
                           stride=None if not strides else int(strides),
                           border_mode=padding,
                           input_shape=_shape(input_shape), **kwargs)


def AveragePooling1D(pool_size=2, strides=None, padding="valid",
                     input_shape=None, **kwargs):
    return K1.AveragePooling1D(pool_length=int(pool_size),
                               stride=None if not strides else int(strides),
                               border_mode=padding,
                               input_shape=_shape(input_shape), **kwargs)


def GlobalMaxPooling1D(input_shape=None, **kwargs):
    return K1.GlobalMaxPooling1D(input_shape=_shape(input_shape), **kwargs)


def GlobalAveragePooling1D(input_shape=None, **kwargs):
    return K1.GlobalAveragePooling1D(input_shape=_shape(input_shape),
                                     **kwargs)


def GlobalAveragePooling2D(data_format="channels_first", input_shape=None,
                           **kwargs):
    ordering = "th" if data_format in ("channels_first", "th") else "tf"
    return K1.GlobalAveragePooling2D(dim_ordering=ordering,
                                     input_shape=_shape(input_shape),
                                     **kwargs)

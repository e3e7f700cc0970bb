"""keras2 convolution layers (counterpart of ``analytics_zoo_tpu/pipeline/
api/keras2/layers/convolutional.py``): ``Conv1D``/``Conv2D``/``Cropping1D``
with tf.keras names (``filters``, ``kernel_size``, ``strides``,
``padding``, ``data_format``) over the v1 ``Convolution1D``/
``Convolution2D``/``Cropping1D``. ``Conv2D`` defaults to
``channels_first``, v1's ``"th"``. The kernels draw as the JAX code's
``nn.Conv`` does (lecun-normal, whatever ``kernel_initializer`` names;
see ``keras/layers/convolutional.py``)."""

from __future__ import annotations

from ...keras import layers as K1

__all__ = ["Conv1D", "Conv2D", "Cropping1D"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def _ordering(data_format):
    if data_format in ("channels_first", "th"):
        return "th"
    if data_format in ("channels_last", "tf"):
        return "tf"
    raise ValueError(f"unknown data_format {data_format!r}")


def _first(v):
    return v[0] if isinstance(v, (tuple, list)) else v


def Conv1D(filters, kernel_size, strides=1, padding="valid",
           activation=None, use_bias=True,
           kernel_initializer="glorot_uniform", bias_initializer="zero",
           kernel_regularizer=None, bias_regularizer=None,
           input_shape=None, **kwargs):
    del bias_initializer
    return K1.Convolution1D(
        nb_filter=int(filters), filter_length=int(_first(kernel_size)),
        activation=activation, border_mode=padding,
        subsample_length=int(_first(strides)), use_bias=use_bias,
        init_method=kernel_initializer, W_regularizer=kernel_regularizer,
        b_regularizer=bias_regularizer,
        input_shape=tuple(input_shape) if input_shape else None, **kwargs)


def Conv2D(filters, kernel_size, strides=(1, 1), padding="valid",
           data_format="channels_first", activation=None, use_bias=True,
           kernel_initializer="glorot_uniform", bias_initializer="zero",
           kernel_regularizer=None, bias_regularizer=None,
           input_shape=None, **kwargs):
    del bias_initializer
    kh, kw = _pair(kernel_size)
    return K1.Convolution2D(
        nb_filter=int(filters), nb_row=int(kh), nb_col=int(kw),
        activation=activation, border_mode=padding,
        subsample=_pair(strides), dim_ordering=_ordering(data_format),
        use_bias=use_bias, init_method=kernel_initializer,
        W_regularizer=kernel_regularizer, b_regularizer=bias_regularizer,
        input_shape=tuple(input_shape) if input_shape else None, **kwargs)


def Cropping1D(cropping=(1, 1), input_shape=None, **kwargs):
    return K1.Cropping1D(cropping=_pair(cropping),
                         input_shape=tuple(input_shape) if input_shape
                         else None, **kwargs)

"""keras2 convolutional-recurrent layer (counterpart of
``analytics_zoo_tpu/pipeline/api/keras2/layers/convolutional_recurrent.
py``): ``ConvLSTM2D(filters, kernel_size)`` over v1's, which computes
square kernels, SAME padding and stride 1 only: anything else is refused
rather than computed wrong."""

from __future__ import annotations

from ...keras import layers as K1
from .convolutional import _pair
from .core import _shape

__all__ = ["ConvLSTM2D"]


def ConvLSTM2D(filters, kernel_size, strides=(1, 1), padding="same",
               data_format="channels_last", return_sequences=False,
               go_backwards=False, input_shape=None, **kwargs):
    kh, kw = _pair(kernel_size)
    if kh != kw:
        raise ValueError(
            f"ConvLSTM2D supports square kernels, got {kernel_size}")
    if padding != "same":
        raise ValueError(
            f"ConvLSTM2D supports padding='same' only, got {padding!r}")
    if _pair(strides) != (1, 1):
        raise ValueError(
            f"ConvLSTM2D supports strides=(1, 1) only, got {strides!r}")
    ordering = "tf" if data_format == "channels_last" else "th"
    return K1.ConvLSTM2D(nb_filter=int(filters), nb_kernel=int(kh),
                         return_sequences=return_sequences,
                         go_backwards=go_backwards,
                         dim_ordering=ordering,
                         input_shape=_shape(None, input_shape), **kwargs)

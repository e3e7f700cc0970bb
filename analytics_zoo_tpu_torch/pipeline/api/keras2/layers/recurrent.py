"""keras2 recurrent layers (counterpart of ``analytics_zoo_tpu/pipeline/
api/keras2/layers/recurrent.py``): ``units`` for v1's ``output_dim``,
``recurrent_activation`` for ``inner_activation``, over the v1
``LSTM``/``GRU``/``SimpleRNN`` (``keras/layers/recurrent.py``)."""

from __future__ import annotations

from ...keras import layers as K1
from .core import _shape

__all__ = ["LSTM", "GRU", "SimpleRNN"]


def LSTM(units, activation="tanh", recurrent_activation="hard_sigmoid",
         return_sequences=False, go_backwards=False,
         kernel_regularizer=None, recurrent_regularizer=None,
         bias_regularizer=None, input_shape=None, **kwargs):
    return K1.LSTM(output_dim=int(units), activation=activation,
                   inner_activation=recurrent_activation,
                   return_sequences=return_sequences,
                   go_backwards=go_backwards,
                   W_regularizer=kernel_regularizer,
                   U_regularizer=recurrent_regularizer,
                   b_regularizer=bias_regularizer,
                   input_shape=_shape(None, input_shape), **kwargs)


def GRU(units, activation="tanh", recurrent_activation="hard_sigmoid",
        return_sequences=False, go_backwards=False,
        kernel_regularizer=None, recurrent_regularizer=None,
        bias_regularizer=None, input_shape=None, **kwargs):
    return K1.GRU(output_dim=int(units), activation=activation,
                  inner_activation=recurrent_activation,
                  return_sequences=return_sequences,
                  go_backwards=go_backwards,
                  W_regularizer=kernel_regularizer,
                  U_regularizer=recurrent_regularizer,
                  b_regularizer=bias_regularizer,
                  input_shape=_shape(None, input_shape), **kwargs)


def SimpleRNN(units, activation="tanh", return_sequences=False,
              go_backwards=False, kernel_regularizer=None,
              recurrent_regularizer=None, bias_regularizer=None,
              input_shape=None, **kwargs):
    return K1.SimpleRNN(output_dim=int(units), activation=activation,
                        return_sequences=return_sequences,
                        go_backwards=go_backwards,
                        W_regularizer=kernel_regularizer,
                        U_regularizer=recurrent_regularizer,
                        b_regularizer=bias_regularizer,
                        input_shape=_shape(None, input_shape), **kwargs)

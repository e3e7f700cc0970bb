"""keras2 core layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/core.py``): ``Dense(units, kernel_initializer)``,
``Activation``, ``Dropout(rate)``, ``Flatten``.

Each factory returns the Keras v1 module (``keras/layers/core.py``), so a
keras2 layer is a v1 layer. ``kernel_initializer`` becomes v1's
``init_method``: ``"glorot_uniform"`` draws Glorot-uniform, any other name
lecun-normal, as flax's ``Dense`` under the JAX v1 layer does. Biases
start at zero whatever ``bias_initializer`` says, as in the JAX package.
"""

from __future__ import annotations

from ...keras import layers as K1

__all__ = ["Dense", "Activation", "Dropout", "Flatten"]


def _shape(input_dim, input_shape):
    if input_dim:
        return (input_dim,)
    return tuple(input_shape) if input_shape else None


def Dense(units, kernel_initializer="glorot_uniform",
          bias_initializer="zero", activation=None, kernel_regularizer=None,
          bias_regularizer=None, use_bias=True, input_dim=None,
          input_shape=None, **kwargs):
    del bias_initializer
    return K1.Dense(output_dim=int(units), activation=activation,
                    use_bias=use_bias, init_method=kernel_initializer,
                    W_regularizer=kernel_regularizer,
                    b_regularizer=bias_regularizer,
                    input_shape=_shape(input_dim, input_shape), **kwargs)


def Activation(activation, input_shape=None, **kwargs):
    return K1.Activation(activation=activation,
                         input_shape=_shape(None, input_shape), **kwargs)


def Dropout(rate, input_shape=None, **kwargs):
    """keras2 names the drop fraction ``rate`` (v1: ``p``)."""
    return K1.Dropout(p=float(rate),
                      input_shape=_shape(None, input_shape), **kwargs)


def Flatten(input_shape=None, **kwargs):
    return K1.Flatten(input_shape=_shape(None, input_shape), **kwargs)

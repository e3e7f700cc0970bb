"""keras2 normalization (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/normalization.py``): ``BatchNormalization(axis, momentum,
epsilon)`` over the v1 layer, which starts beta at zeros and gamma at
ones: other initializers are refused, as in the JAX package."""

from __future__ import annotations

from ...keras import layers as K1
from .core import _shape

__all__ = ["BatchNormalization"]


def BatchNormalization(axis=-1, momentum=0.99, epsilon=1e-3,
                       beta_initializer="zeros", gamma_initializer="ones",
                       input_shape=None, **kwargs):
    if beta_initializer not in ("zeros", "zero"):
        raise ValueError(
            f"beta_initializer={beta_initializer!r} unsupported: "
            "BatchNormalization initializes beta to zeros")
    if gamma_initializer not in ("ones", "one"):
        raise ValueError(
            f"gamma_initializer={gamma_initializer!r} unsupported: "
            "BatchNormalization initializes gamma to ones")
    return K1.BatchNormalization(
        epsilon=float(epsilon), momentum=float(momentum), axis=int(axis),
        input_shape=_shape(None, input_shape), **kwargs)

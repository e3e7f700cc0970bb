"""keras2 advanced activations (counterpart of ``analytics_zoo_tpu/
pipeline/api/keras2/layers/advanced_activations.py``) over the v1
modules."""

from __future__ import annotations

from ...keras import layers as K1
from .core import _shape

__all__ = ["LeakyReLU", "ELU", "PReLU", "ThresholdedReLU"]


def LeakyReLU(alpha=0.3, input_shape=None, **kwargs):
    return K1.LeakyReLU(alpha=float(alpha),
                        input_shape=_shape(None, input_shape), **kwargs)


def ELU(alpha=1.0, input_shape=None, **kwargs):
    return K1.ELU(alpha=float(alpha),
                  input_shape=_shape(None, input_shape), **kwargs)


def PReLU(shared_axes=None, input_shape=None, **kwargs):
    """v1's PReLU learns one shared slope; ``shared_axes`` would change
    the parameters' shape, so it is refused."""
    if shared_axes is not None:
        raise ValueError(
            "PReLU(shared_axes=...) is not supported: PReLU learns one "
            "shared slope (v1 n_output_plane=0)")
    return K1.PReLU(input_shape=_shape(None, input_shape), **kwargs)


def ThresholdedReLU(theta=1.0, input_shape=None, **kwargs):
    return K1.ThresholdedReLU(theta=float(theta),
                              input_shape=_shape(None, input_shape),
                              **kwargs)

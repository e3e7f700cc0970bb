"""keras2 wrappers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/wrappers.py``): ``TimeDistributed`` and ``Bidirectional``
over v1's, the wrapped layer first, as in tf.keras."""

from __future__ import annotations

from ...keras import layers as K1
from .core import _shape

__all__ = ["TimeDistributed", "Bidirectional"]


def TimeDistributed(layer, input_shape=None, **kwargs):
    return K1.TimeDistributed(layer=layer,
                              input_shape=_shape(None, input_shape),
                              **kwargs)


def Bidirectional(layer, merge_mode="concat", input_shape=None, **kwargs):
    return K1.Bidirectional(layer=layer, merge_mode=merge_mode,
                            input_shape=_shape(None, input_shape), **kwargs)

"""keras2 merge layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/merge.py``): ``Maximum``/``Minimum``/``Average`` and their
functional forms, each the v1 ``Merge`` with its mode."""

from __future__ import annotations

from ...keras import layers as K1

__all__ = ["Maximum", "Minimum", "Average",
           "maximum", "minimum", "average"]


def Maximum(input_shape=None, **kwargs):
    return K1.Merge(mode="max", input_shape=input_shape, **kwargs)


def Minimum(input_shape=None, **kwargs):
    return K1.Merge(mode="min", input_shape=input_shape, **kwargs)


def Average(input_shape=None, **kwargs):
    return K1.Merge(mode="ave", input_shape=input_shape, **kwargs)


def maximum(inputs, **kwargs):
    """Functional :func:`Maximum` over Variables or tensors."""
    return Maximum(**kwargs)(*inputs)


def minimum(inputs, **kwargs):
    return Minimum(**kwargs)(*inputs)


def average(inputs, **kwargs):
    return Average(**kwargs)(*inputs)

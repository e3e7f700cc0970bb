"""keras2 noise layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras2/layers/noise.py``): ``stddev`` for v1's ``sigma``, ``rate`` for
``p``."""

from __future__ import annotations

from ...keras import layers as K1
from .core import _shape

__all__ = ["GaussianNoise", "GaussianDropout"]


def GaussianNoise(stddev, input_shape=None, **kwargs):
    return K1.GaussianNoise(sigma=float(stddev),
                            input_shape=_shape(None, input_shape), **kwargs)


def GaussianDropout(rate, input_shape=None, **kwargs):
    return K1.GaussianDropout(p=float(rate),
                              input_shape=_shape(None, input_shape),
                              **kwargs)

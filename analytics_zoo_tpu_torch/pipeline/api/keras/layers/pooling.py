"""Pooling layers (counterpart of ``analytics_zoo_tpu/pipeline/api/keras/
layers/pooling.py``), in the JAX package's layouts: the 1-D layers take
``(batch, steps, dim)``, the 2-D and 3-D ones channels-first for
``dim_ordering="th"`` and channels-last for ``"tf"``.

Windows pad as flax's ``max_pool``/``avg_pool`` do: VALID nothing, SAME by
``convolutional.same_pads`` (more at the end at a stride above 1), with
``-inf`` for the max and zeros for the average, which divides by the
whole window (flax's ``count_include_pad=True``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from .convolutional import (_channels_back, _channels_first, _pad_mode,
                            _torch_pads, same_pads)
from .core import Layer

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def pool(x, kind: str, window, strides, padding: str):
    """flax's pooling of channels-first ``x (N, C, *spatial)``."""
    n = len(window)
    if padding == "SAME":
        pads = [same_pads(x.shape[2 + i], window[i], strides[i])
                for i in range(n)]
        x = F.pad(x, _torch_pads(pads),
                  value=float("-inf") if kind == "max" else 0.0)
    fn = _MAX[n] if kind == "max" else _AVG[n]
    return fn(x, tuple(window), tuple(strides))


class _Pool1D(Layer):
    KIND = "max"

    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 border_mode: str = "valid", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.pool_length, self.stride = pool_length, stride
        self.border_mode = border_mode

    def forward(self, x):
        y = pool(x.transpose(1, 2), self.KIND, (self.pool_length,),
                 (self.stride or self.pool_length,),
                 _pad_mode(self.border_mode))
        return y.transpose(1, 2)


class MaxPooling1D(_Pool1D):
    KIND = "max"


class AveragePooling1D(_Pool1D):
    KIND = "avg"


class _PoolND(Layer):
    KIND = "max"

    def __init__(self, pool_size: Tuple[int, ...] = (2, 2),
                 strides: Optional[Tuple[int, ...]] = None,
                 border_mode: str = "valid", dim_ordering: str = "th",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.pool_size, self.strides = tuple(pool_size), strides
        self.border_mode, self.dim_ordering = border_mode, dim_ordering

    def forward(self, x):
        y = pool(_channels_first(x, self.dim_ordering), self.KIND,
                 self.pool_size, tuple(self.strides or self.pool_size),
                 _pad_mode(self.border_mode))
        return _channels_back(y, self.dim_ordering)


class MaxPooling2D(_PoolND):
    KIND = "max"


class AveragePooling2D(_PoolND):
    KIND = "avg"


class MaxPooling3D(_PoolND):
    KIND = "max"

    def __init__(self, pool_size: Tuple[int, int, int] = (2, 2, 2),
                 strides: Optional[Tuple[int, int, int]] = None,
                 border_mode: str = "valid", dim_ordering: str = "th",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(pool_size, strides, border_mode, dim_ordering,
                         input_shape, name)


class AveragePooling3D(MaxPooling3D):
    KIND = "avg"


class _GlobalPool(Layer):
    REDUCE = "max"

    def __init__(self, dim_ordering: str = "th", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.dim_ordering = dim_ordering

    def forward(self, x):
        if self.dim_ordering == "th" and x.dim() > 3:
            axes = tuple(range(2, x.dim()))
        elif x.dim() > 3:
            axes = tuple(range(1, x.dim() - 1))
        else:                       # 1-D: (batch, steps, dim)
            axes = (1,)
        if self.REDUCE == "max":
            return torch.amax(x, dim=axes)
        return torch.mean(x, dim=axes)


class GlobalMaxPooling1D(_GlobalPool):
    REDUCE = "max"


class GlobalAveragePooling1D(_GlobalPool):
    REDUCE = "mean"


class GlobalMaxPooling2D(_GlobalPool):
    REDUCE = "max"


class GlobalAveragePooling2D(_GlobalPool):
    REDUCE = "mean"


class GlobalMaxPooling3D(_GlobalPool):
    REDUCE = "max"


class GlobalAveragePooling3D(_GlobalPool):
    REDUCE = "mean"

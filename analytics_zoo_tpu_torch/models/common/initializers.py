"""flax's dtype names and initialisers, for the port's modules.

``lecun_normal_`` is flax's ``lecun_normal()``: a normal truncated at two
standard deviations, scaled so that the truncated draw has std
``1/sqrt(fan_in)`` (flax's fan_in of a Dense kernel ``(in, out)`` is
``in``; of a conv kernel ``(kh, kw, in, out)`` it is ``kh * kw * in``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2]: lecun_normal divides by it
TRUNC_STD = 0.87962566103423978


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name (``"bfloat16"``) or a numpy
    or JAX scalar type."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else (
        getattr(dtype, "__name__", None) or getattr(dtype, "name", None)
        or str(dtype))
    out = getattr(torch, str(name).rsplit(".", 1)[-1], None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Fill ``weight`` in place as flax's ``lecun_normal()`` does."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)

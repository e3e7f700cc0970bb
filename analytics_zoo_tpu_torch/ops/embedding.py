"""Embedding lookup (counterpart of ``analytics_zoo_tpu/ops/embedding.py``).

The forward is ``table[ids]`` with the JAX package's ``jnp.take`` index
semantics: a negative id counts from the end of the table, and a row
outside ``[-rows, rows)`` reads as NaN instead of faulting the device, so a
malformed request yields a NaN answer and the server stays up.

``grad_mode`` is accepted and validated as in the JAX package. Its
``onehot``/``auto`` backward numerics (a one-hot matmul in bf16) belong to
the training slice; until then every mode takes autograd's own backward of
the gather, which is the JAX package's ``scatter`` mode.
"""

from __future__ import annotations

import math

import torch
from torch import nn

GRAD_MODES = ("auto", "onehot", "scatter")


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                     grad_mode: str = "auto") -> torch.Tensor:
    """``table[ids]`` over the leading axis of ``table``."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    rows = table.shape[0]
    ids = ids.long()
    valid = (ids >= -rows) & (ids < rows)
    idx = torch.where(ids < 0, ids + rows, ids).clamp(0, rows - 1)
    out = table[idx]
    nan = torch.full((), float("nan"), dtype=out.dtype, device=out.device)
    return torch.where(valid.reshape(valid.shape + (1,) * (out.dim()
                                                           - ids.dim())),
                       out, nan)


class MXUEmbed(nn.Module):
    """The ``MXUEmbed`` counterpart: one ``(num_embeddings, features)``
    parameter named ``embedding`` (checkpoint-compatible with the flax
    module), initialised like flax's ``variance_scaling(1, fan_in,
    normal, out_axis=0)``: normal with std ``1/sqrt(num_embeddings)``."""

    def __init__(self, num_embeddings: int, features: int,
                 grad_mode: str = "auto"):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"unknown grad_mode {grad_mode!r}")
        self.grad_mode = grad_mode
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, features)
            / math.sqrt(num_embeddings))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding_lookup(self.embedding, ids,
                                grad_mode=self.grad_mode)

"""Embedding lookup (counterpart of ``analytics_zoo_tpu/ops/embedding.py``).

The forward is ``table[ids]`` with the JAX package's ``jnp.take`` index
semantics: a negative id counts from the end of the table, and a row
outside ``[-rows, rows)`` reads as NaN instead of faulting the device, so a
malformed request yields a NaN answer and the server stays up.

The backward follows ``grad_mode`` as in the JAX package:

* ``"scatter"`` — autograd's own backward of the gather (a scatter-add):
  exact f32 table gradients. Out-of-range ids get no gradient; negative
  ids send theirs to the row they read.
* ``"onehot"`` — the JAX package's one-hot matmul backward, ``dTable =
  onehot(ids)^T @ g``: the cotangents are rounded to bf16, the one-hot is
  exact, the products are summed in f32 and the result is cast to the
  table's dtype, so table gradients agree with ``scatter`` to bf16
  precision. As in JAX, a negative or out-of-range id matches no row. The
  port computes the same function without the one-hot: each bf16-rounded
  cotangent row is added in f32 (``index_add_`` into zeros) to the row its
  id names. The one-hot matmul would build an ``(ids, rows)`` f32 matrix
  (10 GB for NCF's two tables at batch 262,144) and spend ``2 * ids *
  rows * cols`` flops on it; the sum reads the cotangents once.
  ``onehot_matmul_backward`` keeps the matmul as the plain version the
  tests hold the sum against.
* ``"auto"`` — ``onehot`` for 2-D tables with rows <= ``ONEHOT_ROWS_MAX``
  and rows*cols <= ``ONEHOT_ELEMENTS_MAX`` (BERT's segment table, small
  vocabularies), else ``scatter`` (BERT-Base's 30522 x 768 token table).
  ``ZOO_EMBED_GRAD_MODE`` overrides ``auto``.

The one-hot backward is plain torch ops, as it was XLA ops and not a Pallas
kernel in the JAX package. ``index_add_`` sums with f32 atomics on the
card, so two runs may differ in the last bits of a row that many ids share;
a sort and segment sum would be deterministic at the price of the sort.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..common import knobs

GRAD_MODES = ("auto", "onehot", "scatter")
# the JAX package's crossover (analytics_zoo_tpu/ops/embedding.py)
ONEHOT_ROWS_MAX = 32768
ONEHOT_ELEMENTS_MAX = ONEHOT_ROWS_MAX * 256


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    rows = table.shape[0]
    ids = ids.long()
    valid = (ids >= -rows) & (ids < rows)
    idx = torch.where(ids < 0, ids + rows, ids).clamp(0, rows - 1)
    out = table[idx]
    nan = torch.full((), float("nan"), dtype=out.dtype, device=out.device)
    return torch.where(valid.reshape(valid.shape + (1,) * (out.dim()
                                                           - ids.dim())),
                       out, nan)


class _OneHotLookup(torch.autograd.Function):
    """The gather forward with the one-hot matmul backward."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return _gather(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return onehot_sum_backward(ids, g, ctx.rows, ctx.dtype), None


def _flat_bf16_cotangents(ids, g):
    flat_ids = ids.reshape(-1).long()
    flat_g = g.reshape(-1, g.shape[-1]).to(torch.bfloat16).float()
    return flat_ids, flat_g


def onehot_sum_backward(ids: torch.Tensor, g: torch.Tensor, rows: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """The one-hot backward's function without the one-hot: row ``r`` is
    the f32 sum of the bf16-rounded cotangents whose id is ``r``; an id
    outside ``[0, rows)`` adds nothing. Cast to the table's ``dtype``."""
    flat_ids, flat_g = _flat_bf16_cotangents(ids, g)
    # an id outside [0, rows) adds into a spare last row, dropped below
    idx = torch.where((flat_ids >= 0) & (flat_ids < rows), flat_ids, rows)
    out = torch.zeros(rows + 1, flat_g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, idx, flat_g)[:rows].to(dtype)


def onehot_matmul_backward(ids: torch.Tensor, g: torch.Tensor, rows: int,
                           dtype: torch.dtype) -> torch.Tensor:
    """The plain version: ``onehot(ids)^T @ g`` with the ``(ids, rows)``
    one-hot built in f32, as the JAX package computes it."""
    flat_ids, flat_g = _flat_bf16_cotangents(ids, g)
    rows_ = torch.arange(rows, device=ids.device)
    onehot = (flat_ids[:, None] == rows_[None, :]).float()
    return (onehot.t() @ flat_g).to(dtype)


def take_clamped(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's indexing rules for ``x[ids]``: a negative
    id counts from the end, and an id outside the table reads the nearest
    row (torch's indexing would raise). Its backward is autograd's
    scatter-add, as JAX's."""
    rows = table.shape[0]
    ids = ids.long()
    return table[torch.where(ids < 0, ids + rows, ids).clamp(0, rows - 1)]


def _use_onehot(table: torch.Tensor, grad_mode: str) -> bool:
    if grad_mode == "auto":
        grad_mode = knobs.get("ZOO_EMBED_GRAD_MODE")
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    rows, cols = table.shape[0], math.prod(table.shape[1:])
    return table.dim() == 2 and (
        grad_mode == "onehot"
        or (grad_mode == "auto" and rows <= ONEHOT_ROWS_MAX
            and rows * cols <= ONEHOT_ELEMENTS_MAX))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                     grad_mode: str = "auto") -> torch.Tensor:
    """``table[ids]`` over the leading axis of ``table``, with the backward
    ``grad_mode`` selects (see the module docstring)."""
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    if _use_onehot(table, grad_mode):
        return _OneHotLookup.apply(table, ids)
    return _gather(table, ids)


class MXUEmbed(nn.Module):
    """The ``MXUEmbed`` counterpart: one ``(num_embeddings, features)``
    parameter named ``embedding`` (checkpoint-compatible with the flax
    module), initialised like flax's ``variance_scaling(1, fan_in,
    normal, out_axis=0)``: on a 2-D ``(num_embeddings, features)`` shape
    that fan_in is ``features``, so the table is N(0, 1/features), std
    ``1/sqrt(features)``."""

    def __init__(self, num_embeddings: int, features: int,
                 grad_mode: str = "auto"):
        super().__init__()
        if grad_mode not in GRAD_MODES:
            raise ValueError(f"unknown grad_mode {grad_mode!r}")
        self.grad_mode = grad_mode
        self.embedding = nn.Parameter(
            torch.randn(num_embeddings, features) / math.sqrt(features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embedding_lookup(self.embedding, ids,
                                grad_mode=self.grad_mode)

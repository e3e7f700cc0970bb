"""Wide & Deep recommender (counterpart of ``analytics_zoo_tpu/models/
recommendation/wide_and_deep.py``).

The input is the reference's concatenated float tensor ``[wide |
indicator | embed_ids | continuous]``. The wide branch is ``wide_linear``
over the one/multi-hot wide columns; the deep branch embeds each
categorical column (``embed_{i}``, an ``MXUEmbed`` of ``in_dim + 1``
rows, ids truncated to ints and clipped to ``[0, in_dim]``), concatenates
indicator, embeddings and continuous features, and runs ``deep_dense_{k}``
with relu and ``deep_head``. The two branches' logits are summed, then a
softmax. Parameter names are flax's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.embedding import MXUEmbed
from ...pipeline.api.keras.layers.self_attention import dense
from ..common.zoo_model import ZooModel


class ColumnFeatureInfo:
    """The column layout (reference wide_and_deep.py:60)."""

    def __init__(self, wide_base_cols=None, wide_base_dims=None,
                 wide_cross_cols=None, wide_cross_dims=None,
                 indicator_cols=None, indicator_dims=None, embed_cols=None,
                 embed_in_dims=None, embed_out_dims=None,
                 continuous_cols=None, label="label", **_):
        self.wide_base_cols = list(wide_base_cols or [])
        self.wide_base_dims = [int(d) for d in (wide_base_dims or [])]
        self.wide_cross_cols = list(wide_cross_cols or [])
        self.wide_cross_dims = [int(d) for d in (wide_cross_dims or [])]
        self.indicator_cols = list(indicator_cols or [])
        self.indicator_dims = [int(d) for d in (indicator_dims or [])]
        self.embed_cols = list(embed_cols or [])
        self.embed_in_dims = [int(d) for d in (embed_in_dims or [])]
        self.embed_out_dims = [int(d) for d in (embed_out_dims or [])]
        self.continuous_cols = list(continuous_cols or [])
        self.label = label

    @property
    def wide_dim(self) -> int:
        return sum(self.wide_base_dims) + sum(self.wide_cross_dims)

    @property
    def indicator_dim(self) -> int:
        return sum(self.indicator_dims)

    def feature_width(self) -> int:
        return (self.wide_dim + self.indicator_dim +
                len(self.embed_in_dims) + len(self.continuous_cols))


class WideAndDeepNet(nn.Module):
    def __init__(self, class_num: int, model_type: str = "wide_n_deep",
                 wide_dim: int = 0, indicator_dim: int = 0,
                 embed_in_dims: Tuple[int, ...] = (),
                 embed_out_dims: Tuple[int, ...] = (),
                 continuous_count: int = 0,
                 hidden_layers: Tuple[int, ...] = (40, 20, 10)):
        super().__init__()
        self.config = dict(class_num=class_num, model_type=model_type,
                           wide_dim=wide_dim, indicator_dim=indicator_dim,
                           embed_in_dims=tuple(embed_in_dims),
                           embed_out_dims=tuple(embed_out_dims),
                           continuous_count=continuous_count,
                           hidden_layers=tuple(hidden_layers))
        self.model_type = model_type
        self.wide_dim, self.indicator_dim = wide_dim, indicator_dim
        self.embed_in_dims = tuple(embed_in_dims)
        self.continuous_count = continuous_count
        self.hidden_layers = tuple(hidden_layers)
        if model_type in ("wide", "wide_n_deep"):
            self.wide_linear = dense(wide_dim, class_num)
        if model_type in ("deep", "wide_n_deep"):
            width = indicator_dim + continuous_count
            for i, (in_dim, out_dim) in enumerate(zip(embed_in_dims,
                                                      embed_out_dims)):
                self.add_module(f"embed_{i}", MXUEmbed(in_dim + 1, out_dim))
                width += out_dim
            for k, units in enumerate(hidden_layers):
                self.add_module(f"deep_dense_{k}", dense(width, units))
                width = units
            self.deep_head = dense(width, class_num)

    def forward(self, x):
        ofs = 0
        wide = x[:, ofs:ofs + self.wide_dim]
        ofs += self.wide_dim
        indicator = x[:, ofs:ofs + self.indicator_dim]
        ofs += self.indicator_dim
        embed_ids = x[:, ofs:ofs + len(self.embed_in_dims)]
        ofs += len(self.embed_in_dims)
        continuous = x[:, ofs:ofs + self.continuous_count]
        logits = 0.0
        if self.model_type in ("wide", "wide_n_deep"):
            logits = logits + self.wide_linear(wide)
        if self.model_type in ("deep", "wide_n_deep"):
            parts = [indicator] if self.indicator_dim else []
            for i, in_dim in enumerate(self.embed_in_dims):
                ids = embed_ids[:, i].long().clamp(0, in_dim)
                parts.append(getattr(self, f"embed_{i}")(ids))
            if self.continuous_count:
                parts.append(continuous)
            h = torch.cat(parts, dim=-1)
            for k in range(len(self.hidden_layers)):
                h = torch.relu(getattr(self, f"deep_dense_{k}")(h))
            logits = logits + self.deep_head(h)
        return torch.softmax(logits, dim=-1)


class WideAndDeep(ZooModel):
    """``WideAndDeep(class_num, column_info, model_type, hidden_layers)``
    (reference wide_and_deep.py:94); trains on ``cuda`` unless
    ``device="cpu"``."""

    def __init__(self, class_num, column_info: ColumnFeatureInfo,
                 model_type: str = "wide_n_deep",
                 hidden_layers: Sequence[int] = (40, 20, 10), device=None,
                 **_):
        assert model_type in ("wide", "deep", "wide_n_deep")
        self.column_info = column_info
        module = WideAndDeepNet(
            class_num=int(class_num), model_type=model_type,
            wide_dim=column_info.wide_dim,
            indicator_dim=column_info.indicator_dim,
            embed_in_dims=tuple(column_info.embed_in_dims),
            embed_out_dims=tuple(column_info.embed_out_dims),
            continuous_count=len(column_info.continuous_cols),
            hidden_layers=tuple(int(u) for u in hidden_layers))
        super().__init__(module, device)

    def recommend_for_user(self, user_item_pairs, max_items: int = 5):
        """Ranks each user's rows by the last class's probability, through
        ``NeuralCF.recommend_for_user`` (columns 0 and 1 name the user and
        the item), as the JAX package does."""
        from .neuralcf import NeuralCF
        return NeuralCF.recommend_for_user(self, user_item_pairs, max_items)

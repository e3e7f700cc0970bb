"""SessionRecommender (counterpart of ``analytics_zoo_tpu/models/
recommendation/session_recommender.py``): stacked GRUs over the session's
item ids, with an MLP over the mean embedding of the purchase history when
``include_history``, and a softmax over the ``item_count + 1`` ids.

Parameters carry flax's names: ``item_embedding`` (ids clipped to ``[0,
item_count]``), the cells ``GRUCell_{k}`` (flax names them by class: their
``nn.RNN`` wrappers ``gru_{k}`` hold no parameters), ``rnn_head``, and
with history ``hist_embedding``, ``mlp_{k}`` and ``mlp_head``. Each GRU
runs its sequence in one cuDNN call on the card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.embedding import MXUEmbed
from ...pipeline.api.keras.layers.recurrent import GRUCell
from ...pipeline.api.keras.layers.self_attention import dense
from ..common.zoo_model import ZooModel


class SessionRecommenderNet(nn.Module):
    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers: Tuple[int, ...] = (40, 20),
                 session_length: int = 5, include_history: bool = False,
                 mlp_hidden_layers: Tuple[int, ...] = (40, 20),
                 history_length: int = 10):
        super().__init__()
        self.config = dict(item_count=item_count, item_embed=item_embed,
                           rnn_hidden_layers=tuple(rnn_hidden_layers),
                           session_length=session_length,
                           include_history=include_history,
                           mlp_hidden_layers=tuple(mlp_hidden_layers),
                           history_length=history_length)
        self.item_count, self.session_length = item_count, session_length
        self.include_history, self.history_length = (include_history,
                                                     history_length)
        self.n_rnn, self.n_mlp = len(rnn_hidden_layers), len(
            mlp_hidden_layers)
        self.item_embedding = MXUEmbed(item_count + 1, item_embed)
        width = item_embed
        for k, units in enumerate(rnn_hidden_layers):
            self.add_module(f"GRUCell_{k}", GRUCell(width, units))
            width = units
        self.rnn_head = dense(width, item_count + 1)
        if include_history:
            self.hist_embedding = MXUEmbed(item_count + 1, item_embed)
            width = item_embed
            for k, units in enumerate(mlp_hidden_layers):
                self.add_module(f"mlp_{k}", dense(width, units))
                width = units
            self.mlp_head = dense(width, item_count + 1)

    def forward(self, x):
        """``x``: ``(batch, session_length)`` item ids, or with history
        ``(batch, session_length + history_length)``."""
        ids = x.long()
        h = self.item_embedding(ids[:, :self.session_length].clamp(
            0, self.item_count))
        for k in range(self.n_rnn):
            h, _ = getattr(self, f"GRUCell_{k}")(h)
        logits = self.rnn_head(h[:, -1, :])
        if self.include_history:
            hist = ids[:, self.session_length:
                       self.session_length + self.history_length]
            m = self.hist_embedding(hist.clamp(0, self.item_count)).mean(1)
            for k in range(self.n_mlp):
                m = torch.relu(getattr(self, f"mlp_{k}")(m))
            logits = logits + self.mlp_head(m)
        return torch.softmax(logits, dim=-1)


class SessionRecommender(ZooModel):
    def __init__(self, item_count, item_embed=100,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 5, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 10, device=None, **_):
        module = SessionRecommenderNet(
            item_count=int(item_count), item_embed=int(item_embed),
            rnn_hidden_layers=tuple(int(u) for u in rnn_hidden_layers),
            session_length=int(session_length),
            include_history=include_history,
            mlp_hidden_layers=tuple(int(u) for u in mlp_hidden_layers),
            history_length=int(history_length))
        super().__init__(module, device)

    def recommend_for_session(self, sessions: np.ndarray, max_items: int = 5,
                              zero_based_label: bool = True):
        """The ``max_items`` most probable ids of each session, with their
        probabilities."""
        probs = np.asarray(self.predict(np.asarray(sessions)))
        top = np.argsort(-probs, axis=-1)[:, :max_items]
        if not zero_based_label:
            top = top + 1
        return [list(zip(row, probs[i, row]))
                for i, row in enumerate(top)]

"""Seq2Seq encoder-decoder (counterpart of ``analytics_zoo_tpu/models/
seq2seq/seq2seq.py``): teacher-forced training, ``module(src, tgt_in)`` ->
per-step probabilities over the target vocabulary, and greedy ``infer``.

Parameters carry flax's names: ``encoder`` and ``decoder`` each hold
``embedding`` (an ``MXUEmbed``, when the side has a vocabulary) and their
cells ``LSTMCell_{i}`` / ``GRUCell_{i}`` / ``SimpleCell_{i}`` (flax names
the cells that the JAX module builds inline by class and index, not by
the ``rnn_{i}`` of their ``nn.RNN`` wrappers, which hold no parameters);
``bridge_dense`` with ``bridge="dense"``; ``generator``.

The encoder's final carries seed the decoder's layers (flax's LSTM carry
is ``(c, h)``); ``bridge="dense"`` maps every carry leaf through the one
shared ``bridge_dense``. Each layer runs its whole sequence in one cuDNN
call on the card. A side without a vocabulary takes vectors, whose width
comes from the first input (a lazy parameter).

``infer`` keeps the JAX package's algorithm: it re-decodes the growing
prefix at every step (a fixed-shape loop of ``max_seq_len - 1`` full
forwards) and writes the argmax of step ``i`` at ``i + 1``, so its tokens
equal JAX's for the same weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.embedding import MXUEmbed
from ...pipeline.api.keras.layers.recurrent import (GRUCell, LSTMCell,
                                                    SimpleCell)
from ...pipeline.api.keras.layers.self_attention import dense
from ..common.zoo_model import ZooModel

_CELLS = {"lstm": LSTMCell, "gru": GRUCell, "simplernn": SimpleCell}


def _cell_class(rnn_type: str):
    try:
        return _CELLS[rnn_type.lower()]
    except KeyError:
        raise ValueError(f"unsupported rnn_type {rnn_type!r}")


class _RNNStack(nn.Module):
    def __init__(self, rnn_type: str = "lstm", nlayers: int = 1,
                 hidden_size: int = 128, vocab_size: int = 0,
                 embed_dim: int = 0):
        super().__init__()
        cls = _cell_class(rnn_type)
        self.nlayers = nlayers
        width = None
        if vocab_size:
            width = embed_dim or hidden_size
            self.embedding = MXUEmbed(vocab_size, width)
        for i in range(nlayers):
            self.add_module(f"{cls.__name__}_{i}", cls(width, hidden_size))
            width = hidden_size
        self.cell_names = [f"{cls.__name__}_{i}" for i in range(nlayers)]

    def _embed(self, x):
        return self.embedding(x.long()) if hasattr(self, "embedding") else x


class RNNEncoder(_RNNStack):
    """The stack over the source; returns the last layer's outputs and
    every layer's final carry."""

    def forward(self, x):
        h, carries = self._embed(x), []
        for name in self.cell_names:
            h, carry = getattr(self, name)(h)
            carries.append(carry)
        return h, carries


class RNNDecoder(_RNNStack):
    """The same stack over the target, each layer started from the given
    carry."""

    def forward(self, y, init_carries):
        h = self._embed(y)
        for name, carry in zip(self.cell_names, init_carries):
            h, _ = getattr(self, name)(h, carry)
        return h


class Seq2SeqNet(nn.Module):
    def __init__(self, rnn_type: str = "lstm", nlayers: int = 1,
                 hidden_size: int = 128, src_vocab: int = 0,
                 tgt_vocab: int = 0, embed_dim: int = 0,
                 bridge: str = "passthrough"):
        super().__init__()
        self.config = dict(rnn_type=rnn_type, nlayers=nlayers,
                           hidden_size=hidden_size, src_vocab=src_vocab,
                           tgt_vocab=tgt_vocab, embed_dim=embed_dim,
                           bridge=bridge)
        self.bridge, self.tgt_vocab = bridge, tgt_vocab
        self.encoder = RNNEncoder(rnn_type, nlayers, hidden_size, src_vocab,
                                  embed_dim)
        self.decoder = RNNDecoder(rnn_type, nlayers, hidden_size, tgt_vocab,
                                  embed_dim)
        if bridge == "dense":
            self.bridge_dense = dense(hidden_size, hidden_size)
        if tgt_vocab:
            self.generator = dense(hidden_size, tgt_vocab)

    def _bridge(self, carries):
        if self.bridge == "passthrough":
            return carries
        return [tuple(self.bridge_dense(c) for c in carry)
                if isinstance(carry, tuple) else self.bridge_dense(carry)
                for carry in carries]

    def forward(self, src, tgt):
        _, carries = self.encoder(src)
        out = self.decoder(tgt, self._bridge(carries))
        if self.tgt_vocab:
            # probabilities: the Keras-style losses read them
            return torch.softmax(self.generator(out), dim=-1)
        return out


class Seq2Seq(ZooModel):
    """``Seq2Seq(rnn_type, nlayers, hidden_size, src_vocab, tgt_vocab,
    embed_dim, bridge)``; data is ``{"x": (src, tgt_in), "y": tgt_out}``.
    Trains on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, rnn_type="lstm", nlayers=1, hidden_size=128,
                 src_vocab=0, tgt_vocab=0, embed_dim=0,
                 bridge="passthrough", device=None, **_):
        module = Seq2SeqNet(rnn_type=rnn_type, nlayers=int(nlayers),
                            hidden_size=int(hidden_size),
                            src_vocab=int(src_vocab),
                            tgt_vocab=int(tgt_vocab),
                            embed_dim=int(embed_dim), bridge=bridge)
        super().__init__(module, device)

    def infer(self, src: np.ndarray, start_sign: int, max_seq_len: int = 30,
              stop_sign: Optional[int] = None) -> np.ndarray:
        """Greedy decode (reference Seq2Seq.infer): int ids ``(batch,
        max_seq_len)`` starting with ``start_sign``."""
        est = self.estimator
        module = self.module
        src = torch.as_tensor(np.asarray(src), device=est.device)
        tokens = torch.full((src.shape[0], max_seq_len), int(start_sign),
                            dtype=torch.int32, device=est.device)
        was_training = module.training
        module.eval()
        with torch.no_grad():
            for i in range(max_seq_len - 1):
                probs = module(src, tokens)
                tokens[:, i + 1] = probs[:, i].argmax(-1).to(torch.int32)
        module.train(was_training)
        return tokens.cpu().numpy()

"""Keras-style text models (counterpart of ``analytics_zoo_tpu/tfpark/
text/keras.py``): BiLSTM taggers over word (and character) embeddings,
trained by the port's ``TPUEstimator``.

* ``NER``: word embeddings and a character CNN (a SAME ``Conv(3)`` over
  each word's characters, then the max over them) -> BiLSTM -> per-token
  tag logits (greedy decoding, no CRF, as in the JAX package);
* ``POSTagger``: the same skeleton;
* ``IntentEntity``: a shared BiLSTM, the intent head on its mean over the
  sentence and the slot head on every token, packed into one ``(b, 1 + s,
  max(num_intents, num_entities))`` logits tensor padded with ``-1e9``.

Parameters carry flax's names: ``word_embedding``, ``char_embedding``,
``char_conv``, ``bilstm.LSTMCell_0`` (forward) and ``bilstm.LSTMCell_1``
(backward: flax's ``reverse=True, keep_order=True``), ``tag_head``,
``intent_head``, ``slot_head``. Each direction runs in one cuDNN call on
the card; the BiLSTM's input width comes from its first input. The token
cross-entropy ignores label 0 (padding). The models train on ``cuda``
unless ``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.embedding import MXUEmbed
from ...orca.learn.estimator import TPUEstimator
from ...orca.learn.losses import sparse_categorical_crossentropy
from ...pipeline.api.keras.layers.convolutional import FlaxConv
from ...pipeline.api.keras.layers.recurrent import LSTMCell
from ...pipeline.api.keras.layers.self_attention import Dropout, dense


def _token_ce(y, logits):
    """Per-token cross-entropy over the tokens whose label is not 0
    (padding), averaged per sentence."""
    per_tok = sparse_categorical_crossentropy(y, logits, from_logits=True)
    mask = (y > 0).to(per_tok.dtype)
    return (per_tok * mask).sum(-1) / mask.sum(-1).clamp_min(1.0)


class _BiLSTM(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.LSTMCell_0 = LSTMCell(None, units)
        self.LSTMCell_1 = LSTMCell(None, units)

    def forward(self, x):
        fwd, _ = self.LSTMCell_0(x)
        bwd, _ = self.LSTMCell_1(x, reverse=True)
        return torch.cat([fwd, bwd], dim=-1)


class _TaggerNet(nn.Module):
    """word ids ``(b, s)`` [+ char ids ``(b, s, w)``] -> per-token tag
    logits."""

    def __init__(self, vocab_size: int, num_tags: int,
                 word_emb_dim: int = 100, char_vocab_size: int = 0,
                 char_emb_dim: int = 30, lstm_units: int = 100,
                 dropout: float = 0.5):
        super().__init__()
        self.char_emb_dim = char_emb_dim
        self.word_embedding = MXUEmbed(vocab_size, word_emb_dim)
        if char_vocab_size:
            self.char_embedding = MXUEmbed(char_vocab_size, char_emb_dim)
            self.char_conv = FlaxConv(char_emb_dim, (3,), padding="SAME",
                                      in_features=char_emb_dim)
        self.drop_in, self.drop_out = Dropout(dropout), Dropout(dropout)
        self.bilstm = _BiLSTM(lstm_units)
        self.tag_head = dense(2 * lstm_units, num_tags)

    def forward(self, word_ids, char_ids=None):
        h = self.word_embedding(word_ids.long())
        if char_ids is not None and hasattr(self, "char_embedding"):
            c = self.char_embedding(char_ids.long())
            b, s, w, d = c.shape
            c = self.char_conv(c.reshape(b * s, w, d).transpose(1, 2))
            c = c.amax(dim=2).reshape(b, s, self.char_emb_dim)
            h = torch.cat([h, c], dim=-1)
        h = self.drop_out(self.bilstm(self.drop_in(h)))
        return self.tag_head(h)


class _Tagger:
    """Shared estimator wrapper of NER and POSTagger."""

    def __init__(self, num_tags: int, vocab_size: int,
                 char_vocab_size: int = 0, word_emb_dim: int = 100,
                 char_emb_dim: int = 30, lstm_units: int = 100,
                 dropout: float = 0.5, optimizer="adam", device=None):
        self.module = _TaggerNet(
            vocab_size=vocab_size, num_tags=num_tags,
            word_emb_dim=word_emb_dim, char_vocab_size=char_vocab_size,
            char_emb_dim=char_emb_dim, lstm_units=lstm_units,
            dropout=dropout)
        self.estimator = TPUEstimator(self.module, loss=_token_ce,
                                      optimizer=optimizer, device=device)

    def fit(self, x, y, batch_size: int = 32, epochs: int = 1, **kw):
        return self.estimator.fit({"x": x, "y": y}, epochs=epochs,
                                  batch_size=batch_size, **kw)

    def evaluate(self, x, y, batch_size: int = 32):
        return self.estimator.evaluate({"x": x, "y": y},
                                       batch_size=batch_size)

    def predict(self, x, batch_size: int = 32):
        logits = self.estimator.predict(x, batch_size=batch_size)
        return np.argmax(np.asarray(logits), axis=-1)

    def save_model(self, path: str):
        return self.estimator.save(path)

    def load_model(self, path: str):
        self.estimator.load(path)
        return self


class NER(_Tagger):
    """(reference ner.py NER: nlp-architect's NERCRF)"""


class POSTagger(_Tagger):
    """(reference pos_tagging.py POSTagger)"""


class _IntentEntityNet(nn.Module):
    def __init__(self, vocab_size: int, num_intents: int,
                 num_entities: int, word_emb_dim: int = 100,
                 lstm_units: int = 100, dropout: float = 0.5):
        super().__init__()
        self.width = max(num_intents, num_entities)
        self.word_embedding = MXUEmbed(vocab_size, word_emb_dim)
        self.drop_in, self.drop_out = Dropout(dropout), Dropout(dropout)
        self.bilstm = _BiLSTM(lstm_units)
        self.intent_head = dense(2 * lstm_units, num_intents)
        self.slot_head = dense(2 * lstm_units, num_entities)

    def _pad(self, t):
        return F.pad(t, (0, self.width - t.shape[-1]), value=-1e9)

    def forward(self, word_ids):
        h = self.word_embedding(word_ids.long())
        h = self.drop_out(self.bilstm(self.drop_in(h)))
        intent_logits = self.intent_head(h.mean(dim=1))
        slot_logits = self.slot_head(h)
        return torch.cat([self._pad(intent_logits)[:, None],
                          self._pad(slot_logits)], dim=1)


def _intent_entity_loss(num_intents, num_entities):
    def loss(y, packed):
        # y: (b, 1 + s), y[:, 0] the intent id, y[:, 1:] slot ids (0 = PAD)
        intent_l = sparse_categorical_crossentropy(
            y[:, 0], packed[:, 0, :num_intents], from_logits=True)
        slot_l = _token_ce(y[:, 1:], packed[:, 1:, :num_entities])
        return intent_l + slot_l
    return loss


class IntentEntity:
    """Joint intent and slot model (reference intent_extraction.py
    MultiTaskIntentModel). Labels pack as ``(b, 1 + s)``: column 0 the
    intent id, the rest per-token slot ids (0 = PAD)."""

    def __init__(self, num_intents: int, num_entities: int, vocab_size: int,
                 word_emb_dim: int = 100, lstm_units: int = 100,
                 dropout: float = 0.5, optimizer="adam", device=None):
        self.num_intents = num_intents
        self.num_entities = num_entities
        self.module = _IntentEntityNet(
            vocab_size=vocab_size, num_intents=num_intents,
            num_entities=num_entities, word_emb_dim=word_emb_dim,
            lstm_units=lstm_units, dropout=dropout)
        self.estimator = TPUEstimator(
            self.module, loss=_intent_entity_loss(num_intents, num_entities),
            optimizer=optimizer, device=device)

    @staticmethod
    def pack_labels(intents: np.ndarray, slots: np.ndarray) -> np.ndarray:
        return np.concatenate([np.asarray(intents).reshape(-1, 1),
                               np.asarray(slots)], axis=1).astype(np.int32)

    def fit(self, x, intents, slots, batch_size: int = 32, epochs: int = 1,
            **kw):
        y = self.pack_labels(intents, slots)
        return self.estimator.fit({"x": x, "y": y}, epochs=epochs,
                                  batch_size=batch_size, **kw)

    def predict(self, x, batch_size: int = 32
                ) -> Tuple[np.ndarray, np.ndarray]:
        packed = np.asarray(self.estimator.predict(x,
                                                   batch_size=batch_size))
        intent = np.argmax(packed[:, 0, :self.num_intents], axis=-1)
        slots = np.argmax(packed[:, 1:, :self.num_entities], axis=-1)
        return intent, slots

    def save_model(self, path: str):
        return self.estimator.save(path)

    def load_model(self, path: str):
        self.estimator.load(path)
        return self

"""BERT text estimators (counterpart of ``analytics_zoo_tpu/tfpark/text/
estimator.py``): the encoder-plus-head module they train and serve,
``bert_input_fn``, and ``BERTClassifier``, ``BERTNER`` and ``BERTSQuAD``
on the port's ``TPUEstimator``. They train on ``cuda`` unless given
``device="cpu"``.

Feature dict convention (the reference's ``bert_input_fn``): ``input_ids``,
optional ``token_type_ids`` (or ``segment_ids``), optional ``input_mask``
(or ``attention_mask``); labels under ``label_ids``.
"""

from __future__ import annotations

import json
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...orca.learn.estimator import TPUEstimator
from ...orca.learn.losses import sparse_categorical_crossentropy
from ...pipeline.api.keras.layers.self_attention import BERT, Dropout, dense

# google-research/bert's bert_config.json for BERT-Base, Uncased, under the
# keys BERT takes (the JAX package's BERTBaseEstimator reads the same keys
# from a bert_config.json)
BERT_BASE = {"vocab": 30522, "hidden_size": 768, "n_block": 12,
             "n_head": 12, "seq_len": 512, "intermediate_size": 3072,
             "hidden_p_drop": 0.1, "attn_p_drop": 0.1}


def bert_input_fn(features: Dict[str, np.ndarray],
                  labels: Optional[np.ndarray] = None,
                  batch_size: int = 32) -> Dict[str, Any]:
    """Assemble the estimator data dict from BERT feature arrays: ``x`` is
    the ids alone, or the positional tuple (ids, token_type_ids[,
    input_mask])."""
    ids = np.asarray(features["input_ids"], np.int32)
    xs = [ids]
    tt = features.get("token_type_ids", features.get("segment_ids"))
    mask = features.get("input_mask", features.get("attention_mask"))
    if tt is not None or mask is not None:
        xs.append(np.asarray(tt, np.int32) if tt is not None
                  else np.zeros_like(ids))
    if mask is not None:
        xs.append(np.asarray(mask, np.int32))
    data: Dict[str, Any] = {"x": tuple(xs) if len(xs) > 1 else xs[0]}
    if labels is not None:
        data["y"] = labels
    return data


class _BertWithHead(nn.Module):
    """BERT encoder + task head. head: ``pooled`` (b, h) -> logits over
    classes (classification); ``tokens`` per-token logits (b, s, num_out),
    which is also the span head of SQuAD with ``num_out=2``."""

    def __init__(self, bert_kwargs, num_out: int, head: str = "pooled",
                 head_drop: float = 0.1):
        super().__init__()
        if head not in ("pooled", "tokens"):
            raise ValueError(f"unknown head {head!r}")
        self.bert = BERT(**dict(bert_kwargs))
        self.head_kind = head
        self.head_drop = Dropout(head_drop) if head_drop else None
        self.head = dense(self.bert.pooler.in_features, num_out)

    def forward(self, ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                input_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        seq, pooled = self.bert(ids, token_type_ids,
                                attention_mask=input_mask)
        h = pooled if self.head_kind == "pooled" else seq
        if self.head_drop is not None:
            h = self.head_drop(h)
        return self.head(h)


class BERTBaseEstimator(TPUEstimator):
    """Shared constructor: BERT hyper-parameters passed directly
    (``bert_config`` and keyword overrides) or read from a Google
    ``bert_config.json`` (``bert_config_file``); ``init_checkpoint`` loads
    a file written by ``save``."""

    def __init__(self, *, num_out: int, head: str,
                 bert_config: Optional[dict] = None,
                 bert_config_file: Optional[str] = None,
                 init_checkpoint: Optional[str] = None,
                 optimizer="adam", loss=None, metrics=None,
                 model_dir: Optional[str] = None, device=None,
                 **bert_kwargs):
        if bert_config_file:
            with open(bert_config_file) as f:
                raw = json.load(f)
            bert_config = {
                "vocab": raw.get("vocab_size", 30522),
                "hidden_size": raw.get("hidden_size", 768),
                "n_block": raw.get("num_hidden_layers", 12),
                "n_head": raw.get("num_attention_heads", 12),
                "seq_len": raw.get("max_position_embeddings", 512),
                "intermediate_size": raw.get("intermediate_size", 3072),
                "hidden_p_drop": raw.get("hidden_dropout_prob", 0.1),
                "attn_p_drop": raw.get(
                    "attention_probs_dropout_prob", 0.1)}
        cfg = dict(bert_config or {})
        cfg.update(bert_kwargs)
        module = _BertWithHead(tuple(sorted(cfg.items())), num_out=num_out,
                               head=head)
        super().__init__(module, loss=loss, optimizer=optimizer,
                         metrics=metrics, model_dir=model_dir,
                         device=device)
        if init_checkpoint:
            self.load(init_checkpoint)


class BERTClassifier(BERTBaseEstimator):
    """Sequence classification on the pooled [CLS] output."""

    def __init__(self, num_classes: int, **kwargs):
        kwargs.setdefault("loss", partial(sparse_categorical_crossentropy,
                                          from_logits=True))
        kwargs.setdefault("metrics", ["sparse_categorical_accuracy"])
        super().__init__(num_out=num_classes, head="pooled", **kwargs)


class BERTNER(BERTBaseEstimator):
    """Token-level entity tagging: per-token logits, labels (b, s)."""

    def __init__(self, num_entities: int, **kwargs):
        kwargs.setdefault("loss", partial(sparse_categorical_crossentropy,
                                          from_logits=True))
        kwargs.setdefault("metrics", None)
        super().__init__(num_out=num_entities, head="tokens", **kwargs)


def _squad_loss(y, logits):
    """y: (b, 2) start/end token indices; logits: (b, s, 2). The mean of
    the start and end cross-entropies."""
    def ce(pos_logits, pos):
        logp = torch.log_softmax(pos_logits, -1)
        return -logp.gather(-1, pos.long()[:, None])[:, 0]

    return 0.5 * (ce(logits[..., 0], y[:, 0]) + ce(logits[..., 1], y[:, 1]))


class BERTSQuAD(BERTBaseEstimator):
    """Extractive QA: start/end span logits per token."""

    def __init__(self, **kwargs):
        kwargs.setdefault("loss", _squad_loss)
        kwargs.setdefault("metrics", None)
        super().__init__(num_out=2, head="tokens", **kwargs)

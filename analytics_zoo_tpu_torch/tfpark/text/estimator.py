"""BERT task model (counterpart of ``analytics_zoo_tpu/tfpark/text/
estimator.py``): the encoder-plus-head module the BERT estimators train
and serve, and ``bert_input_fn``. The estimators themselves
(``BERTClassifier``, ``BERTNER``, ``BERTSQuAD``) train, and come with the
training slice.

Feature dict convention (the reference's ``bert_input_fn``): ``input_ids``,
optional ``token_type_ids`` (or ``segment_ids``), optional ``input_mask``
(or ``attention_mask``); labels under ``label_ids``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ...pipeline.api.keras.layers.self_attention import BERT, dense

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
        self.head_drop = nn.Dropout(head_drop) if head_drop else None
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

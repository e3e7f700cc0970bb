"""TextClassifier (counterpart of ``analytics_zoo_tpu/models/
textclassification/text_classifier.py``): a word embedding, a ``cnn``,
``lstm`` or ``gru`` encoder, dropout 0.2, ``Dense(128)`` with relu and a
softmax head. The head returns probabilities, as the Keras-style losses
(``from_logits=False``) read them.

Parameters carry flax's names: ``embedding`` (a pretrained matrix as the
parameter itself, else the ``MXUEmbed`` table ``embedding.embedding``),
``conv`` (the ``cnn`` encoder's ``(out, in, 5)`` kernel, flax's ``(5, in,
out)``), ``LSTMCell_0`` or ``GRUCell_0`` (the recurrent encoder's cell:
flax names the cell it builds inline by class), ``fc`` and ``head``.

* ``cnn``: a VALID convolution of width 5, relu, then the max over time.
* ``lstm``/``gru``: the cell over the sequence in one cuDNN call on the
  card, the last step's output. Sequences are post-padded
  (``TextSet.shape_sequence``), so that step is often padding, as in the
  JAX package.
* A given matrix is frozen: it stays a parameter named ``embedding`` (so
  ``interop`` finds it) that takes no gradient, so ``fit`` leaves it bit
  for bit as it was; ids read it by JAX's indexing rules
  (``take_clamped``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.embedding import MXUEmbed, take_clamped
from ...pipeline.api.keras.layers.convolutional import FlaxConv
from ...pipeline.api.keras.layers.recurrent import GRUCell, LSTMCell
from ...pipeline.api.keras.layers.self_attention import Dropout, dense
from ..common.zoo_model import ZooModel


class TextClassifierNet(nn.Module):
    def __init__(self, class_num: int, vocab_size: int = 0,
                 embed_dim: int = 200, embedding_matrix=None,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256):
        super().__init__()
        self.config = dict(class_num=class_num, vocab_size=vocab_size,
                           embed_dim=embed_dim,
                           sequence_length=sequence_length, encoder=encoder,
                           encoder_output_dim=encoder_output_dim)
        self.encoder = encoder.lower()
        if embedding_matrix is not None:
            mat = torch.from_numpy(np.array(embedding_matrix, np.float32))
            self.embedding = nn.Parameter(mat, requires_grad=False)
            width = mat.shape[1]
        else:
            self.embedding = MXUEmbed(vocab_size, embed_dim)
            width = embed_dim
        out = encoder_output_dim
        if self.encoder == "cnn":
            self.conv = FlaxConv(out, (5,), padding="VALID",
                                 in_features=width)
        elif self.encoder == "lstm":
            self.LSTMCell_0 = LSTMCell(width, out)
        elif self.encoder == "gru":
            self.GRUCell_0 = GRUCell(width, out)
        else:
            raise ValueError(f"unsupported encoder {encoder!r}")
        self.dropout = Dropout(0.2)
        self.fc = dense(out, 128)
        self.head = dense(128, class_num)

    def forward(self, ids):
        if isinstance(self.embedding, nn.Parameter):
            x = take_clamped(self.embedding.detach(), ids)
        else:
            x = self.embedding(ids.long())
        if self.encoder == "cnn":
            h = torch.relu(self.conv(x.transpose(1, 2))).amax(dim=2)
        else:
            cell = self.LSTMCell_0 if self.encoder == "lstm" \
                else self.GRUCell_0
            h = cell(x)[0][:, -1]
        h = torch.relu(self.fc(self.dropout(h)))
        return torch.softmax(self.head(h), dim=-1)


class TextClassifier(ZooModel):
    """``TextClassifier(class_num, embedding_file, word_index,
    sequence_length, encoder, encoder_output_dim)``, as the reference's
    constructor; ``embedding_file`` is a GloVe text file read through
    ``WordEmbedding.from_glove`` over ``word_index``. Trains on ``cuda``
    unless ``device="cpu"``."""

    def __init__(self, class_num, embedding_file: Optional[str] = None,
                 word_index: Optional[dict] = None,
                 sequence_length: int = 500, encoder: str = "cnn",
                 encoder_output_dim: int = 256, vocab_size: int = 20000,
                 embed_dim: int = 200, embedding_matrix=None, device=None,
                 **_):
        if embedding_file is not None and embedding_matrix is None:
            from ...pipeline.api.keras.layers import WordEmbedding
            embedding_matrix = WordEmbedding.from_glove(
                embedding_file, word_index).embedding_matrix
        module = TextClassifierNet(
            class_num=int(class_num), vocab_size=int(vocab_size),
            embed_dim=int(embed_dim), embedding_matrix=embedding_matrix,
            sequence_length=int(sequence_length), encoder=encoder,
            encoder_output_dim=int(encoder_output_dim))
        super().__init__(module, device)

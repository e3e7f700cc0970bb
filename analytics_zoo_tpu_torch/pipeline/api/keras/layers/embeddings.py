"""Embedding layers (counterpart of ``analytics_zoo_tpu/pipeline/api/
keras/layers/embeddings.py``): ``Embedding``, ``SparseEmbedding`` and
``WordEmbedding`` with its GloVe reader.

Each holds its table as the parameter ``embedding``, flax's name.

* ``Embedding`` draws its table as the JAX layer does: ``init_method=
  "uniform"`` is flax's ``uniform(scale=0.05)``, which draws from ``[0,
  0.05)`` (not ``[-0.05, 0.05)``), anything else ``normal(0.05)``. Ids are
  shifted by one when ``zero_based_id=False`` and clipped to the table;
  the lookup is the port's ``embedding_lookup`` (the one-hot backward for
  small tables, as the JAX layer's). ``trainable=False`` stops the
  gradient at the lookup's output, so the table stays exactly as it was.
* ``WordEmbedding`` looks up with ``jnp.take``'s index rules (an id
  outside the table reads NaN) and the plain gather backward; it is
  frozen unless ``trainable``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from .....models.common.initializers import as_torch_dtype
from .....ops.embedding import embedding_lookup
from .core import Layer


class Embedding(Layer):
    def __init__(self, input_dim: int = 1, output_dim: int = 1,
                 init_method: str = "uniform", weights: Any = None,
                 trainable: bool = True, input_shape: Any = None,
                 zero_based_id: bool = True, dtype: Any = torch.float32,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.input_dim, self.output_dim = input_dim, output_dim
        self.trainable, self.zero_based_id = trainable, zero_based_id
        self.init_method, self.weights, self.dtype = (init_method, weights,
                                                      dtype)
        dtype = as_torch_dtype(dtype)
        shape = (input_dim, output_dim)
        if weights is not None:
            table = torch.as_tensor(np.asarray(weights)).to(dtype)
        elif init_method == "uniform":
            table = torch.rand(shape, dtype=dtype) * 0.05
        else:
            table = torch.randn(shape, dtype=dtype) * 0.05
        self.embedding = nn.Parameter(table)

    def forward(self, x):
        idx = x.long()
        if not self.zero_based_id:
            idx = idx - 1
        out = embedding_lookup(self.embedding,
                               idx.clamp(0, self.input_dim - 1))
        return out if self.trainable else out.detach()


class SparseEmbedding(Embedding):
    """The same lookup (sparsity of the input does not change it)."""


class WordEmbedding(Layer):
    """Pretrained word vectors, frozen unless ``trainable``. Build it with
    ``WordEmbedding.from_glove(path, word_index)`` or from a matrix."""

    def __init__(self, embedding_matrix: Any = None, trainable: bool = False,
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.trainable = trainable
        self.embedding_matrix = np.asarray(embedding_matrix, np.float32)
        self.embedding = nn.Parameter(torch.from_numpy(
            self.embedding_matrix.copy()))

    def forward(self, x):
        out = embedding_lookup(self.embedding, x.long(), grad_mode="scatter")
        return out if self.trainable else out.detach()

    @staticmethod
    def get_word_index(glove_path: str):
        idx = {}
        with open(glove_path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                idx[line.split(" ", 1)[0]] = i + 1
        return idx

    @classmethod
    def from_glove(cls, glove_path: str, word_index: Optional[dict] = None,
                   trainable: bool = False):
        """The matrix of ``word_index``'s rows (row 0 and words without a
        vector stay zero) from a GloVe text file."""
        vecs = {}
        with open(glove_path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                vecs[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
        dim = len(next(iter(vecs.values())))
        word_index = word_index or {w: i + 1 for i, w in enumerate(vecs)}
        mat = np.zeros((max(word_index.values()) + 1, dim), np.float32)
        for w, i in word_index.items():
            if w in vecs:
                mat[i] = vecs[w]
        return cls(embedding_matrix=mat, trainable=trainable)

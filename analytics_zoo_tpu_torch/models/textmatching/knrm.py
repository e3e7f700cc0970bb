"""KNRM kernel-pooling ranking model (counterpart of ``analytics_zoo_tpu/
models/textmatching/knrm.py``; paper arXiv:1706.06613).

Input is the reference's packed layout: ``(batch, text1_length +
text2_length)`` int ids, the query's then the document's. The cosine
translation matrix ``(b, L1, L2)`` and its ``(b, L1, L2, K)`` RBF kernels
are materialised, as in the JAX package; kernel ``i`` has mu ``1 - 2 i /
(K - 1)`` and sigma ``sigma``, except the mu = 1.0 kernel, which takes
``exact_sigma``. Soft term frequencies are ``log(max(., 1e-10)) * 0.01``
summed over the query, then ``ranker`` (``Dense(1)``), with a sigmoid for
``target_mode="classification"``.

Parameters carry flax's names: ``embedding`` (the table itself) and
``ranker``. The table is a given matrix or flax's ``uniform(scale=0.1)``,
which draws from ``[0, 0.1)``; ``train_embed=False`` stops its gradient.
Ids read the table by JAX's indexing rules (``take_clamped``: out-of-range
ids clamp). Norms are ``sqrt(sum(x^2))`` written out, as the JAX package's
``jnp.linalg.norm`` computes them (a zero vector's gradient is NaN in
both).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...ops.embedding import take_clamped
from ...pipeline.api.keras.layers.self_attention import dense
from ..common.zoo_model import ZooModel


class KNRMNet(nn.Module):
    def __init__(self, text1_length: int, text2_length: int,
                 vocab_size: int = 0, embed_size: int = 300,
                 embedding_matrix=None, train_embed: bool = True,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking"):
        super().__init__()
        self.config = dict(text1_length=text1_length,
                           text2_length=text2_length, vocab_size=vocab_size,
                           embed_size=embed_size, train_embed=train_embed,
                           kernel_num=kernel_num, sigma=sigma,
                           exact_sigma=exact_sigma, target_mode=target_mode)
        self.text1_length, self.text2_length = text1_length, text2_length
        self.train_embed, self.target_mode = train_embed, target_mode
        if embedding_matrix is not None:
            table = torch.from_numpy(np.array(embedding_matrix, np.float32))
        else:
            table = torch.rand(vocab_size, embed_size) * 0.1
        self.embedding = nn.Parameter(table)
        k = kernel_num
        mus = [1.0 - 2.0 * i / (k - 1) for i in range(k)]
        sigmas = [exact_sigma if i == 0 else sigma for i in range(k)]
        self.register_buffer("mus", torch.tensor(mus, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("sigmas", torch.tensor(sigmas,
                                                    dtype=torch.float32),
                             persistent=False)
        self.ranker = dense(k, 1)

    def forward(self, ids):
        ids = ids.long()
        table = self.embedding if self.train_embed \
            else self.embedding.detach()
        q = take_clamped(table, ids[:, :self.text1_length])
        d = take_clamped(table, ids[:, self.text1_length:
                                    self.text1_length + self.text2_length])
        qn = q / torch.sqrt((q * q).sum(-1, keepdim=True)).clamp_min(1e-12)
        dn = d / torch.sqrt((d * d).sum(-1, keepdim=True)).clamp_min(1e-12)
        trans = torch.einsum("bqe,bde->bqd", qn, dn)        # (b, L1, L2)
        diff = trans[..., None] - self.mus                  # (b, L1, L2, K)
        kernels = torch.exp(-0.5 * diff.square() / self.sigmas.square())
        soft_tf = kernels.sum(2)                            # (b, L1, K)
        phi = (torch.log(soft_tf.clamp_min(1e-10)) * 0.01).sum(1)
        score = self.ranker(phi)
        if self.target_mode == "classification":
            return torch.sigmoid(score)
        return score


class KNRM(ZooModel):
    def __init__(self, text1_length, text2_length,
                 embedding_file: Optional[str] = None,
                 word_index: Optional[dict] = None, train_embed: bool = True,
                 kernel_num: int = 21, sigma: float = 0.1,
                 exact_sigma: float = 0.001, target_mode: str = "ranking",
                 vocab_size: int = 20000, embed_size: int = 300,
                 embedding_matrix=None, device=None, **_):
        if embedding_file is not None and embedding_matrix is None:
            from ...pipeline.api.keras.layers import WordEmbedding
            embedding_matrix = WordEmbedding.from_glove(
                embedding_file, word_index).embedding_matrix
        if embedding_matrix is not None:
            vocab_size, embed_size = np.asarray(embedding_matrix).shape
        module = KNRMNet(
            text1_length=int(text1_length), text2_length=int(text2_length),
            vocab_size=int(vocab_size), embed_size=int(embed_size),
            embedding_matrix=embedding_matrix, train_embed=train_embed,
            kernel_num=int(kernel_num), sigma=float(sigma),
            exact_sigma=float(exact_sigma), target_mode=target_mode)
        super().__init__(module, device)

    # ranking metrics (reference models/common/ranker.py Ranker)
    def evaluate_ndcg(self, x, y, k: int = 10):
        from ..common.ranker import ndcg
        scores = np.asarray(self.predict(x)).reshape(-1)
        return ndcg(np.asarray(y).reshape(-1), scores, k)

    def evaluate_map(self, x, y):
        from ..common.ranker import mean_average_precision
        scores = np.asarray(self.predict(x)).reshape(-1)
        return mean_average_precision(np.asarray(y).reshape(-1), scores)

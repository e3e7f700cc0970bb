"""Neural Collaborative Filtering (counterpart of
``analytics_zoo_tpu/models/recommendation/neuralcf.py``).

Same architecture, constructor surface and parameter names as the JAX
package's ``NeuralCFNet`` (reference: pyzoo/zoo/models/recommendation/
neuralcf.py:30-99): an MLP tower over the user and item embeddings, an
optional GMF branch multiplied elementwise, and a softmax head with
``class_num`` classes. Inputs are int ``(batch, 2)`` [user, item] pairs.

Each side has ONE fused ``(count + 1, embed + mf)`` table: ``[:, :embed]``
feeds the MLP tower and ``[:, embed:]`` the GMF branch, so a sample costs
two gathers instead of four. Lookups go through
:func:`~analytics_zoo_tpu_torch.ops.embedding.embedding_lookup`, whose
``auto`` backward for these small tables is the one-hot backward's
function computed as an f32 row sum.

Dtypes follow flax: the tables are f32; the MLP runs in ``compute_dtype``
(``Dense(dtype=bf16)`` casts its input, kernel and bias to bf16 and returns
bf16); the GMF product is taken in the tables' dtype and then cast; the
head is f32, with a softmax unless ``return_logits``.

Initialisation, each with an explicit generator seeded by ``seed``: the
tables uniform in [0, 0.04) (flax ``uniform(0.04)``), the Dense kernels
lecun-normal (a normal truncated at two standard deviations, std
``sqrt(1 / fan_in) / 0.8796``) and the biases zero. The draws differ from
flax's; weights are carried across with ``interop``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.embedding import embedding_lookup
from ..common.initializers import as_torch_dtype, lecun_normal_
from ..common.zoo_model import ZooModel

logger = logging.getLogger("analytics_zoo_tpu_torch")


class _Dense(nn.Linear):
    """flax ``Dense(dtype=...)``: input, weight and bias cast to ``dtype``,
    the product and the output in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        lecun_normal_(self.weight, in_features, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(h.to(dt), self.weight.to(dt), self.bias.to(dt))


class NeuralCFNet(nn.Module):
    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Tuple[int, ...] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 compute_dtype=torch.float32, return_logits: bool = False,
                 embed_grad_mode: str = "auto", seed: int = 0):
        super().__init__()
        self.user_embed, self.item_embed = int(user_embed), int(item_embed)
        self.include_mf = include_mf
        self.compute_dtype = as_torch_dtype(compute_dtype)
        self.return_logits = return_logits
        self.embed_grad_mode = embed_grad_mode
        self.config: Dict[str, Any] = dict(
            user_count=int(user_count), item_count=int(item_count),
            class_num=int(class_num), user_embed=self.user_embed,
            item_embed=self.item_embed,
            hidden_layers=tuple(int(u) for u in hidden_layers),
            include_mf=include_mf, mf_embed=int(mf_embed),
            compute_dtype=str(self.compute_dtype).rsplit(".", 1)[-1],
            return_logits=return_logits, embed_grad_mode=embed_grad_mode,
            seed=seed)
        gen = torch.Generator().manual_seed(seed)
        mf = int(mf_embed) if include_mf else 0
        self.user_embed_table = nn.Parameter(
            torch.rand(int(user_count) + 1, self.user_embed + mf,
                       generator=gen) * 0.04)
        self.item_embed_table = nn.Parameter(
            torch.rand(int(item_count) + 1, self.item_embed + mf,
                       generator=gen) * 0.04)
        width = self.user_embed + self.item_embed
        for k, units in enumerate(self.config["hidden_layers"]):
            self.add_module(f"mlp_dense_{k}",
                            _Dense(width, units, self.compute_dtype, gen))
            width = units
        self.head = _Dense(width + mf, int(class_num), torch.float32, gen)
        self._n_hidden = len(self.config["hidden_layers"])

    def forward(self, user_item: torch.Tensor) -> torch.Tensor:
        ui = user_item.reshape(user_item.shape[0], 2)
        u = embedding_lookup(self.user_embed_table, ui[:, 0],
                             grad_mode=self.embed_grad_mode)
        i = embedding_lookup(self.item_embed_table, ui[:, 1],
                             grad_mode=self.embed_grad_mode)
        h = torch.cat([u[:, :self.user_embed], i[:, :self.item_embed]],
                      -1).to(self.compute_dtype)
        for k in range(self._n_hidden):
            h = F.relu(getattr(self, f"mlp_dense_{k}")(h))
        if self.include_mf:
            gmf = u[:, self.user_embed:] * i[:, self.item_embed:]
            h = torch.cat([h, gmf.to(self.compute_dtype)], -1)
        logits = self.head(h)
        return logits if self.return_logits else torch.softmax(logits, -1)


class NeuralCF(ZooModel):
    """User-facing wrapper with the reference's constructor signature.
    ``device`` (default: the card) and ``seed`` (the weights' generator)
    are the port's own."""

    def __init__(self, user_count, item_count, class_num, user_embed=20,
                 item_embed=20, hidden_layers=(40, 20, 10), include_mf=True,
                 mf_embed=20, compute_dtype=torch.float32, device=None,
                 seed: int = 0, **kwargs):
        self.user_count = int(user_count)
        self.item_count = int(item_count)
        self.class_num = int(class_num)
        module = NeuralCFNet(
            user_count=self.user_count, item_count=self.item_count,
            class_num=self.class_num, user_embed=int(user_embed),
            item_embed=int(item_embed),
            hidden_layers=tuple(int(u) for u in hidden_layers),
            include_mf=include_mf, mf_embed=int(mf_embed),
            compute_dtype=compute_dtype,
            embed_grad_mode=kwargs.get("embed_grad_mode", "auto"),
            seed=seed)
        super().__init__(module, device=device)

    @staticmethod
    def migrate_legacy_state(state: dict) -> tuple:
        """Convert a pre-fusion checkpoint (separate ``mlp_*_embed`` /
        ``mf_*_embed`` embedding tables, ``<name>.embedding`` in the
        state_dict) to the fused ``user_embed_table``/``item_embed_table``
        layout. Returns (migrated?, new_state); optimizer moments cannot
        be carried across the structural change, so the caller
        re-initialises them."""
        params = state.get("params", {})
        if "user_embed_table" in params or \
                "mlp_user_embed.embedding" not in params:
            return False, state

        def arr(v):
            return v.numpy() if isinstance(v, torch.Tensor) else \
                np.asarray(v)

        new = dict(params)
        u = arr(new.pop("mlp_user_embed.embedding"))
        i = arr(new.pop("mlp_item_embed.embedding"))
        if "mf_user_embed.embedding" in new:
            u = np.concatenate(
                [u, arr(new.pop("mf_user_embed.embedding"))], 1)
            i = np.concatenate(
                [i, arr(new.pop("mf_item_embed.embedding"))], 1)
        new["user_embed_table"] = torch.from_numpy(np.ascontiguousarray(u))
        new["item_embed_table"] = torch.from_numpy(np.ascontiguousarray(i))
        return True, dict(state, params=new)

    def load(self, path: str):
        """Load an estimator checkpoint (``TPUEstimator.save``), accepting
        the fused layout and pre-fusion per-branch checkpoints (migrated on
        the fly; a migrated load restarts the optimizer moments)."""
        est = self.estimator
        state = torch.load(path, map_location="cpu", weights_only=False)
        migrated, state = self.migrate_legacy_state(state)
        if migrated:
            state = dict(state, opt_state=None)
            est.engine.opt = None
            logger.warning(
                "migrated pre-fusion NeuralCF checkpoint: embedding tables "
                "concatenated into the fused layout; optimizer state "
                "reinitialized")
        est.engine.set_state(state)
        return self

    def recommend_for_user(self, user_item_pairs, max_items: int = 5):
        """Rank candidate items per user by the last class's predicted
        probability (reference Recommender.recommend_for_user,
        pyzoo/zoo/models/recommendation/recommender.py)."""
        probs = self.predict(user_item_pairs)
        score = probs[:, -1] if probs.ndim == 2 else probs
        users = np.asarray(user_item_pairs)[:, 0]
        out = {}
        for u in np.unique(users):
            m = users == u
            items = np.asarray(user_item_pairs)[m, 1]
            order = np.argsort(-score[m])[:max_items]
            out[int(u)] = [(int(items[i]), float(score[m][i])) for i in order]
        return out


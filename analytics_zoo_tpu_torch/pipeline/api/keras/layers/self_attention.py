"""Transformer / BERT layers (counterpart of ``analytics_zoo_tpu/pipeline/
api/keras/layers/self_attention.py``).

Attention routes through ``ops/attention.py``: the hand-written CUDA flash
forward on the card. Submodule and parameter names follow the flax modules
(``block_{i}/attention/{qkv,proj}``, ``norm1``, ``ffn_in``, ...), so
``interop.py`` maps a flax parameter tree onto these ``state_dict`` keys
one to one.

Numerics that must match the JAX package: ``jax.nn.gelu`` is the tanh
approximation; LayerNorm eps is 1e-5 in the blocks and 1e-12 in
``embedding_norm``. flax's LayerNorm takes the variance as E[x^2]-E[x]^2,
``torch.nn.LayerNorm`` as E[(x-E[x])^2]; at these widths the two agree to
well inside the f32 tolerance of the port's tests (2e-4).

Dropout follows torch's idiom: active in ``train()`` mode, off in
``eval()`` (the flax modules' ``train=False``). It draws its mask from the
``torch.Generator`` the training engine hands it in ``build`` and reseeds
at every step (see ``orca/learn/engine.py``), or from torch's global
generator when it has none.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .....ops.attention import flash_attention, mha_reference
from .....ops.embedding import MXUEmbed


class DrawsRandom:
    """Mixin of a layer that draws random numbers in training. Attribute
    ``generator``: a ``torch.Generator`` on the input's device, or None
    for torch's global one; the training engine sets it to its own."""

    generator: Optional[torch.Generator] = None


class Dropout(DrawsRandom, nn.Module):
    """``nn.Dropout`` that can draw from a given generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator)
        return x * keep * (1.0 / (1.0 - self.p))


def dense(in_features: int, out_features: int) -> nn.Linear:
    """``nn.Linear`` initialised like flax's ``Dense``: lecun normal
    (std ``1/sqrt(fan_in)``, truncated at two deviations), zero bias."""
    layer = nn.Linear(in_features, out_features)
    std = 1.0 / math.sqrt(in_features) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class MultiHeadAttention(nn.Module):
    """Projections + attention core. Strategies ``full`` and ``flash``;
    ``ring`` and ``ulysses`` (sequence parallelism) are not ported yet."""

    def __init__(self, n_head: int = 12, hidden_size: int = 768,
                 attn_dropout: float = 0.0, causal: bool = False,
                 strategy: str = "flash"):
        super().__init__()
        if strategy in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention strategy {strategy!r} is not ported yet")
        if strategy not in ("full", "flash"):
            raise ValueError(f"unknown attention strategy {strategy!r}")
        self.n_head, self.hidden_size = n_head, hidden_size
        self.causal, self.strategy = causal, strategy
        self.qkv = dense(hidden_size, 3 * hidden_size)
        self.proj = dense(hidden_size, hidden_size)
        self.dropout = Dropout(attn_dropout) if attn_dropout else None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, _ = x.shape
        h, hs = self.n_head, self.hidden_size
        d = hs // h
        q, k, v = self.qkv(x).split(hs, dim=-1)
        q = q.reshape(b, s, h, d)
        k = k.reshape(b, s, h, d)
        v = v.reshape(b, s, h, d)
        if self.strategy == "flash" and mask is None:
            out = flash_attention(q, k, v, causal=self.causal)
        else:
            bias = None
            if mask is not None:
                # mask: (b, s) 1=keep -> additive bias broadcast over heads
                bias = (1.0 - mask[:, None, None, :].float()) * -1e9
            out = mha_reference(q, k, v, causal=self.causal, bias=bias)
        out = self.proj(out.reshape(b, s, hs))
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class TransformerBlock(nn.Module):
    """Post-norm (BERT-style) transformer block."""

    def __init__(self, n_head: int = 12, hidden_size: int = 768,
                 intermediate_size: int = 3072, hidden_drop: float = 0.1,
                 attn_drop: float = 0.1, causal: bool = False,
                 activation: str = "gelu", strategy: str = "flash"):
        super().__init__()
        self.attention = MultiHeadAttention(
            n_head=n_head, hidden_size=hidden_size, attn_dropout=attn_drop,
            causal=causal, strategy=strategy)
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.ffn_in = dense(hidden_size, intermediate_size)
        self.ffn_out = dense(intermediate_size, hidden_size)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.activation = activation
        self.dropout = Dropout(hidden_drop) if hidden_drop else None

    def _drop(self, x):
        return x if self.dropout is None else self.dropout(x)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.norm1(x + self._drop(self.attention(x, mask)))
        ff = self.ffn_in(x)
        ff = (F.gelu(ff, approximate="tanh") if self.activation == "gelu"
              else F.relu(ff))
        ff = self._drop(self.ffn_out(ff))
        return self.norm2(x + ff)


def _add_blocks(owner: nn.Module, n_block: int, **kwargs) -> list:
    """Register ``block_0 .. block_{n-1}`` under the flax names."""
    blocks = []
    for i in range(n_block):
        blk = TransformerBlock(**kwargs)
        owner.add_module(f"block_{i}", blk)
        blocks.append(blk)
    return blocks


class TransformerLayer(nn.Module):
    """GPT-style decoder stack: int token ids (b, s) -> (b, s, hidden),
    causal flash attention when ``mask_attention``."""

    def __init__(self, vocab: int = 40990, seq_len: int = 77,
                 n_block: int = 12, n_head: int = 12,
                 hidden_size: int = 768,
                 intermediate_size: Optional[int] = None,
                 hidden_drop: float = 0.1, attn_drop: float = 0.1,
                 embedding_drop: float = 0.1, mask_attention: bool = True,
                 strategy: str = "flash"):
        super().__init__()
        self.token_embedding = MXUEmbed(vocab, hidden_size)
        self.position_embedding = nn.Parameter(
            torch.randn(seq_len, hidden_size) * 0.02)
        self.embedding_drop = (Dropout(embedding_drop) if embedding_drop
                               else None)
        self._blocks = _add_blocks(
            self, n_block, n_head=n_head, hidden_size=hidden_size,
            intermediate_size=intermediate_size or 4 * hidden_size,
            hidden_drop=hidden_drop, attn_drop=attn_drop,
            causal=mask_attention, strategy=strategy)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tok = self.token_embedding(ids)
        x = tok + self.position_embedding[None, :tok.shape[1]]
        if self.embedding_drop is not None:
            x = self.embedding_drop(x)
        for blk in self._blocks:
            x = blk(x)
        return x


class BERT(nn.Module):
    """BERT encoder. Inputs: token ids, token type ids, optional attention
    mask (1=keep). Returns (sequence_output, pooled_output). Without a mask
    every block takes the flash strategy; a mask switches to ``full`` with
    a -1e9 additive bias, as in the JAX package."""

    def __init__(self, vocab: int = 40990, hidden_size: int = 768,
                 n_block: int = 12, n_head: int = 12, seq_len: int = 512,
                 intermediate_size: int = 3072, hidden_p_drop: float = 0.1,
                 attn_p_drop: float = 0.1, strategy: str = "flash"):
        super().__init__()
        self.token_embedding = MXUEmbed(vocab, hidden_size)
        self.segment_embedding = MXUEmbed(2, hidden_size)
        self.position_embedding = nn.Parameter(
            torch.randn(seq_len, hidden_size) * 0.02)
        self.embedding_norm = nn.LayerNorm(hidden_size, eps=1e-12)
        self.dropout = Dropout(hidden_p_drop) if hidden_p_drop else None
        block_kwargs = dict(n_head=n_head, hidden_size=hidden_size,
                            intermediate_size=intermediate_size,
                            hidden_drop=hidden_p_drop, attn_drop=attn_p_drop,
                            causal=False)
        self._blocks = _add_blocks(self, n_block, strategy=strategy,
                                   **block_kwargs)
        self.pooler = dense(hidden_size, hidden_size)

    def forward(self, ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None):
        tok = self.token_embedding(ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        seg = self.segment_embedding(token_type_ids)
        x = tok + seg + self.position_embedding[None, :ids.shape[1]]
        x = self.embedding_norm(x)
        if self.dropout is not None:
            x = self.dropout(x)
        # a mask sends every block's attention to the materialised-scores
        # core (MultiHeadAttention takes flash only when mask is None)
        for blk in self._blocks:
            x = blk(x, attention_mask)
        pooled = torch.tanh(self.pooler(x[:, 0]))
        return x, pooled

"""Time-series network modules backing the Zouwu forecasters (counterpart
of ``analytics_zoo_tpu/zouwu/model/nets.py``), as ``nn.Module``s on
``(B, T, F)`` inputs.

Each module takes its input width ``input_dim`` at construction (flax
infers it from the first batch), and carries flax's parameter names, so
``interop`` maps a flax tree onto its ``state_dict`` by name:

* ``LSTMNet``: ``OptimizedLSTMCell_{i}`` (the JAX module names its
  ``nn.RNN`` ``lstm_{i}``, but that wrapper holds no parameters, so flax
  names the cells by class and index) and ``head``.
* ``Seq2SeqNet``: ``encoder``, ``decoder`` (cells) and ``head``.
* ``TCNNet``: ``block_{i}.CausalConv1D_{0,1}.Conv_0`` and, where the
  block changes the width, ``block_{i}.downsample``; ``head``.
* ``MTNetLite``: ``CausalConv1D_0.Conv_0``, ``attn``, ``head``, ``ar``.

An ``OptimizedLSTMCell`` is the Keras layers' ``LSTMCell``
(``pipeline/api/keras/layers/recurrent.py``): flax's per-gate parameters
(input kernels ``ii``/``if``/``ig``/``io`` without bias, hidden kernels
``hi``/``hf``/``hg``/``ho`` with one), run as one ``torch.lstm`` call
over the whole sequence (cuDNN's LSTM on the card) with the hidden
gates' biases as ``b_ih`` and a zero, untrained ``b_hh``. flax adds one
bias per gate; training both of ``nn.LSTM``'s biases would double the
bias's SGD step and change Adam's.

Dropout is the port's ``Dropout`` (it draws from the training engine's
generator), placed where the JAX modules place it: after every LSTM layer
of ``LSTMNet``, the last included; after each conv of a TCN block; after
MTNetLite's conv. ``Seq2SeqNet`` keeps a ``dropout`` field that it never
applies, as in the JAX package.

Convolutions: flax's are channels-last; here ``CausalConv1D`` takes and
returns ``(B, T, C)`` and runs ``nn.Conv1d`` on the transposed input,
padded by ``(K - 1) * d`` on both sides with the last ``(K - 1) * d``
outputs dropped (the reference TCN's ``Chomp1d``), which equals flax's
left pad and VALID dilated conv.

Init as flax's (``models/common/initializers.py``): input kernels, Dense
and Conv kernels ``lecun_normal`` (truncated; a conv's fan_in is ``K *
in``), hidden gate kernels orthogonal per gate ``(h, h)``, biases zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...models.common.initializers import lecun_normal_
from ...pipeline.api.keras.layers.recurrent import LSTMCell
from ...pipeline.api.keras.layers.self_attention import Dropout


def _dense(in_features: int, out_features: int,
           bias: bool = True) -> nn.Linear:
    """flax's ``Dense``: lecun normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(layer.weight, in_features)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


# flax's OptimizedLSTMCell holds LSTMCell's parameters and computes its
# function: the Keras layers' cell serves both
OptimizedLSTMCell = LSTMCell


class LSTMNet(nn.Module):
    """Stacked LSTM -> Dense(target_dim). Input (B, T, F) -> (B,
    target_dim)."""

    def __init__(self, input_dim: int, target_dim: int = 1,
                 lstm_units: Tuple[int, ...] = (16, 8),
                 dropouts: Tuple[float, ...] = (0.2, 0.2)):
        super().__init__()
        self.lstm_units = tuple(int(u) for u in lstm_units)
        self.target_dim = target_dim
        width = input_dim
        self.drops = nn.ModuleList()
        for i, units in enumerate(self.lstm_units):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            OptimizedLSTMCell(width, units))
            rate = dropouts[min(i, len(dropouts) - 1)]
            self.drops.append(Dropout(float(rate)) if rate
                              else nn.Identity())
            width = units
        self.head = _dense(width, target_dim)

    def forward(self, x):
        for i in range(len(self.lstm_units)):
            x, _ = getattr(self, f"OptimizedLSTMCell_{i}")(x)
            x = self.drops[i](x)
        return self.head(x[:, -1])


class CausalConv1D(nn.Module):
    """Left-padded dilated 1-D conv on ``(B, T, C)``."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int,
                 dilation: int = 1):
        super().__init__()
        self.pad = (kernel_size - 1) * dilation
        self.Conv_0 = nn.Conv1d(in_channels, channels, kernel_size,
                                dilation=dilation, padding=self.pad)
        lecun_normal_(self.Conv_0.weight, kernel_size * in_channels)
        nn.init.zeros_(self.Conv_0.bias)

    def forward(self, x):
        y = self.Conv_0(x.transpose(1, 2))
        if self.pad:
            y = y[..., :-self.pad]
        return y.transpose(1, 2)


class TCNBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, kernel_size: int,
                 dilation: int, dropout: float):
        super().__init__()
        self.CausalConv1D_0 = CausalConv1D(in_channels, channels,
                                           kernel_size, dilation)
        self.CausalConv1D_1 = CausalConv1D(channels, channels, kernel_size,
                                           dilation)
        self.drop_0 = Dropout(dropout)
        self.drop_1 = Dropout(dropout)
        if in_channels != channels:
            self.downsample = _dense(in_channels, channels)
        else:
            self.downsample = None

    def forward(self, x):
        y = self.drop_0(F.relu(self.CausalConv1D_0(x)))
        y = self.drop_1(F.relu(self.CausalConv1D_1(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class TCNNet(nn.Module):
    """Dilated causal TCN encoder -> linear head mapping the last
    receptive-field step to (future_seq_len, output_dim).
    Input (B, past, F) -> (B, future, output_dim)."""

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_dim: int, output_feature_num: int = 1,
                 num_channels: Sequence[int] = (30,) * 8,
                 kernel_size: int = 7, dropout: float = 0.2):
        super().__init__()
        self.future_seq_len = future_seq_len
        self.output_feature_num = output_feature_num
        self.num_channels = tuple(int(c) for c in num_channels)
        width = input_dim
        for i, ch in enumerate(self.num_channels):
            self.add_module(f"block_{i}", TCNBlock(width, ch, kernel_size,
                                                   2 ** i, dropout))
            width = ch
        self.head = _dense(width, future_seq_len * output_feature_num)

    def forward(self, x):
        for i in range(len(self.num_channels)):
            x = getattr(self, f"block_{i}")(x)
        out = self.head(x[:, -1])
        return out.reshape(out.shape[0], self.future_seq_len,
                           self.output_feature_num)


class Seq2SeqNet(nn.Module):
    """LSTM encoder-decoder (reference zouwu/model/Seq2Seq.py): the encoder
    folds the past; the decoder unrolls future_seq_len steps feeding back
    its output, one single-step LSTM call each."""

    def __init__(self, input_dim: int, future_seq_len: int,
                 output_feature_num: int = 1, latent_dim: int = 128,
                 dropout: float = 0.2):
        super().__init__()
        self.future_seq_len = future_seq_len
        self.output_feature_num = output_feature_num
        self.dropout = dropout          # never applied, as in JAX
        self.encoder = OptimizedLSTMCell(input_dim, latent_dim)
        self.decoder = OptimizedLSTMCell(output_feature_num, latent_dim)
        self.head = _dense(latent_dim, output_feature_num)

    def forward(self, x):
        _, carry = self.encoder(x)
        y = x.new_zeros(x.shape[0], 1, self.output_feature_num)
        ys = []
        for _ in range(self.future_seq_len):
            h, carry = self.decoder(y, carry)
            y = self.head(h)
            ys.append(y)
        return torch.cat(ys, dim=1)


class MTNetLite(nn.Module):
    """Compact MTNet-style forecaster: a causal conv over the window,
    attention over time, and an autoregressive linear path over the last
    ``ar_window`` steps (the JAX package's lite variant of the reference's
    MTNet keras model). ``ar`` sees ``x[:, -ar_window:, :]`` flattened
    row-major over (T, F), as flax's reshape flattens it."""

    def __init__(self, input_dim: int, target_dim: int = 1,
                 ar_window: int = 4, cnn_kernel: int = 3,
                 cnn_channels: int = 32, dropout: float = 0.2):
        super().__init__()
        self.ar_window = ar_window
        self.CausalConv1D_0 = CausalConv1D(input_dim, cnn_channels,
                                           cnn_kernel)
        self.drop = Dropout(dropout)
        self.attn = _dense(cnn_channels, 1)
        self.head = _dense(cnn_channels, target_dim)
        self.ar = _dense(ar_window * input_dim, target_dim)

    def forward(self, x):
        y = self.drop(F.relu(self.CausalConv1D_0(x)))
        att = torch.softmax(self.attn(y), dim=1)            # (B, T, 1)
        nonlinear = self.head((att * y).sum(dim=1))
        ar_in = x[:, -self.ar_window:, :].reshape(x.shape[0], -1)
        return nonlinear + self.ar(ar_in)

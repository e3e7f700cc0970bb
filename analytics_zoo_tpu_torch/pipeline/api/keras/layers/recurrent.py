"""Recurrent layers (counterpart of ``analytics_zoo_tpu/pipeline/api/keras/
layers/recurrent.py``): ``SimpleRNN``, ``LSTM``, ``GRU``, ``ConvLSTM2D``,
``Bidirectional`` and ``TimeDistributed``, and the flax cells that they and
the model zoo's recurrent models run.

Cells keep flax's parameters under flax's names, so ``interop`` maps a
flax tree onto their ``state_dict`` by name (the Dense rule):

* ``LSTMCell``: input kernels ``ii``/``if``/``ig``/``io`` without bias,
  hidden kernels ``hi``/``hf``/``hg``/``ho`` with one (flax's
  ``LSTMCell`` and ``OptimizedLSTMCell`` hold the same tree);
* ``GRUCell``: ``ir``/``iz``/``in`` with bias, ``hr``/``hz`` without,
  ``hn`` with;
* ``SimpleCell``: ``i`` with bias, ``h`` without;
* ``ConvLSTMCell``: the convolutions ``ih`` and ``hh``, both with bias.

A flax cell built inline and handed to ``nn.RNN`` belongs to the module
that builds it, so flax names it by class and index (``LSTMCell_0``); the
layers here hold their cell under that name.

Where the gate function is the sigmoid and the cell function tanh (tanh
or relu for ``SimpleCell``), a cell runs the whole sequence as one call
of torch's fused RNN (cuDNN's on the card): its weights are views of one
buffer laid out as cuDNN's weight space for one layer, in torch's gate
order, which is flax's (``i, f, g, o``; ``r, z, n``). flax adds one bias
per gate; torch's formula has two, so the second is zero and untrained
(for the GRU ``b_hh = [0, 0, b_hn]``, since flax's ``hn`` carries the
bias that sits inside the reset gate's product). Any other pair of
functions (the Keras default ``inner_activation="hard_sigmoid"``) runs
an explicit loop of the cell over time with the port's ``activations``:
the input projections of all steps in one matmul, then one hidden matmul
and the gate arithmetic a step.

``go_backwards`` (flax's ``reverse=True, keep_order=True``) runs the
sequence from its end and returns the outputs in input order, so the last
processed step is index 0. A cell's carry starts at zeros; the LSTM's is
flax's ``(c, h)``.

Init as flax's: input kernels ``lecun_normal`` (their width may wait for
the first input, a lazy parameter), hidden kernels orthogonal per gate,
biases zero; convolutions ``lecun_normal``.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .....models.common.initializers import lecun_normal_
from .. import activations
from .convolutional import FlaxConv
from .core import FlaxLinear, Layer


def input_dense(in_features: Optional[int], features: int,
                bias: bool) -> nn.Module:
    """flax's ``Dense`` on the cell's input: lecun normal kernel, zero
    bias; a lazy width when ``in_features`` is None."""
    if in_features is None:
        return FlaxLinear(features, bias, "lecun_normal")
    layer = nn.Linear(in_features, features, bias=bias)
    lecun_normal_(layer.weight, in_features)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def hidden_dense(features: int, bias: bool) -> nn.Linear:
    """flax's recurrent ``Dense``: orthogonal ``(h, h)`` kernel, zero
    bias."""
    layer = nn.Linear(features, features, bias=bias)
    nn.init.orthogonal_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _one_buffer(groups):
    """Each group of tensors stacked along its first axis, as views of one
    buffer (cuDNN's weight space for one layer), so that cuDNN reads them
    where they are."""
    flat = torch.cat([p.reshape(-1) for group in groups for p in group])
    sizes = [sum(p.numel() for p in group) for group in groups]
    return [v.view((-1,) + tuple(group[0].shape[1:]))
            for v, group in zip(flat.split(sizes), groups)]


class _Cell(nn.Module):
    """A flax cell run over a whole ``(B, T, in)`` sequence."""

    INPUTS: Tuple[str, ...] = ()

    def __init__(self, features: int, activation, gate):
        super().__init__()
        self.features = features
        self.activation, self.gate = activation, gate

    def _materialize(self, x):
        for name in self.INPUTS:
            d = getattr(self, name)
            if isinstance(d, FlaxLinear) and d.has_uninitialized_params():
                d(x.new_zeros(0, x.shape[-1]))

    def _fused_call(self) -> bool:
        """Whether the gate and cell functions are the ones torch's fused
        RNN computes."""
        return (activations.get(self.gate) is torch.sigmoid
                and activations.get(self.activation) is torch.tanh)

    def initial_carry(self, x):
        return x.new_zeros(x.shape[0], self.features)

    def forward(self, x: torch.Tensor, carry=None, reverse: bool = False):
        """``x (B, T, in)`` -> ``(outputs (B, T, h), final carry)``."""
        self._materialize(x)
        if reverse:
            x = x.flip(1)
        if carry is None:
            carry = self.initial_carry(x)
        train = self.training or torch.is_grad_enabled()
        if self._fused_call():
            out, carry = self._fused(x, carry, train)
        else:
            out, carry = self._loop(x, carry, activations.get(self.gate),
                                    activations.get(self.activation))
        return (out.flip(1) if reverse else out), carry


class LSTMCell(_Cell):
    """flax's ``LSTMCell``: ``i, f, o = gate(.)``, ``g = act(.)``, ``c' =
    f c + i g``, ``h' = o act(c')``; the carry is ``(c, h)``."""

    INPUTS = ("ii", "if", "ig", "io")

    def __init__(self, in_features: Optional[int], features: int,
                 activation: Union[str, Callable] = "tanh",
                 gate: Union[str, Callable] = "sigmoid"):
        super().__init__(features, activation, gate)
        for g in "ifgo":
            self.add_module(f"i{g}", input_dense(in_features, features,
                                                 False))
            self.add_module(f"h{g}", hidden_dense(features, True))
        self.register_buffer("zero_bias", torch.zeros(4 * features),
                             persistent=False)

    def fused_weights(self):
        """``[w_ih (4h, in), w_hh (4h, h), b_ih (4h,), b_hh (4h,) = 0]``
        in torch's gate order."""
        return _one_buffer(
            [[getattr(self, f"i{g}").weight for g in "ifgo"],
             [getattr(self, f"h{g}").weight for g in "ifgo"],
             [getattr(self, f"h{g}").bias for g in "ifgo"],
             [self.zero_bias]])

    def initial_carry(self, x):
        zeros = x.new_zeros(x.shape[0], self.features)
        return zeros, zeros

    def _fused(self, x, carry, train):
        c, h = carry
        out, h_n, c_n = torch.lstm(x, (h[None], c[None]),
                                   self.fused_weights(), True, 1, 0.0, train,
                                   False, True)
        return out, (c_n[0], h_n[0])

    def _loop(self, x, carry, gate, act):
        w_ih, w_hh, b_ih, _ = self.fused_weights()
        xp = F.linear(x, w_ih, b_ih)
        c, h = carry
        outs = []
        for t in range(x.shape[1]):
            i, f, g, o = (xp[:, t] + F.linear(h, w_hh)).chunk(4, -1)
            c = gate(f) * c + gate(i) * act(g)
            h = gate(o) * act(c)
            outs.append(h)
        return torch.stack(outs, 1), (c, h)


class GRUCell(_Cell):
    """flax's ``GRUCell``: ``r = gate(ir x + hr h)``, ``z = gate(iz x + hz
    h)``, ``n = act(in x + r (hn h))``, ``h' = (1 - z) n + z h``."""

    INPUTS = ("ir", "iz", "in")

    def __init__(self, in_features: Optional[int], features: int,
                 activation: Union[str, Callable] = "tanh",
                 gate: Union[str, Callable] = "sigmoid"):
        super().__init__(features, activation, gate)
        for g in "rzn":
            self.add_module(f"i{g}", input_dense(in_features, features,
                                                 True))
            self.add_module(f"h{g}", hidden_dense(features, g == "n"))
        self.register_buffer("zero_bias", torch.zeros(2 * features),
                             persistent=False)

    def fused_weights(self):
        """``[w_ih (3h, in), w_hh (3h, h), b_ih (3h,), b_hh = [0, 0,
        b_hn]]`` in torch's gate order."""
        return _one_buffer(
            [[getattr(self, f"i{g}").weight for g in "rzn"],
             [getattr(self, f"h{g}").weight for g in "rzn"],
             [getattr(self, f"i{g}").bias for g in "rzn"],
             [self.zero_bias, self.hn.bias]])

    def _fused(self, x, h, train):
        out, h_n = torch.gru(x, h[None], self.fused_weights(), True, 1, 0.0,
                             train, False, True)
        return out, h_n[0]

    def _loop(self, x, h, gate, act):
        w_ih, w_hh, b_ih, b_hh = self.fused_weights()
        xp = F.linear(x, w_ih, b_ih)
        outs = []
        for t in range(x.shape[1]):
            xr, xz, xn = xp[:, t].chunk(3, -1)
            hr, hz, hn = F.linear(h, w_hh, b_hh).chunk(3, -1)
            r, z = gate(xr + hr), gate(xz + hz)
            h = (1.0 - z) * act(xn + r * hn) + z * h
            outs.append(h)
        return torch.stack(outs, 1), h


class SimpleCell(_Cell):
    """flax's ``SimpleCell``: ``h' = act(i x + h h)``."""

    INPUTS = ("i",)

    def __init__(self, in_features: Optional[int], features: int,
                 activation: Union[str, Callable] = "tanh"):
        super().__init__(features, activation, None)
        self.i = input_dense(in_features, features, True)
        self.h = hidden_dense(features, False)
        self.register_buffer("zero_bias", torch.zeros(features),
                             persistent=False)

    def _fused_call(self) -> bool:
        return activations.get(self.activation) in (torch.tanh, F.relu)

    def fused_weights(self):
        return _one_buffer([[self.i.weight], [self.h.weight],
                            [self.i.bias], [self.zero_bias]])

    def _fused(self, x, h, train):
        run = (torch.rnn_tanh if activations.get(self.activation)
               is torch.tanh else torch.rnn_relu)
        out, h_n = run(x, h[None], self.fused_weights(), True, 1, 0.0, train,
                       False, True)
        return out, h_n[0]

    def _loop(self, x, h, gate, act):
        xp = self.i(x)
        outs = []
        for t in range(x.shape[1]):
            h = act(xp[:, t] + self.h(h))
            outs.append(h)
        return torch.stack(outs, 1), h


class ConvLSTMCell(nn.Module):
    """flax's ``ConvLSTMCell`` on channels-first steps ``(B, C, H, W)``:
    ``gates = ih(x) + hh(h)`` split ``i, g, f, o``, ``f = sigmoid(f +
    1)``, SAME convolutions at stride 1."""

    def __init__(self, features: int, kernel_size: Tuple[int, int]):
        super().__init__()
        self.features = features
        self.ih = FlaxConv(4 * features, kernel_size, padding="SAME")
        self.hh = FlaxConv(4 * features, kernel_size, padding="SAME",
                           in_features=features)

    def forward(self, x: torch.Tensor, reverse: bool = False):
        """``x (B, T, C, H, W)`` -> ``(outputs (B, T, F, H, W), (c,
        h))``."""
        if reverse:
            x = x.flip(1)
        b, _, _, height, width = x.shape
        c = h = x.new_zeros(b, self.features, height, width)
        outs = []
        for t in range(x.shape[1]):
            i, g, f, o = (self.ih(x[:, t]) + self.hh(h)).chunk(4, 1)
            c = torch.sigmoid(f + 1) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        out = torch.stack(outs, 1)
        return (out.flip(1) if reverse else out), (c, h)


class _Recurrent(Layer):
    """A Keras recurrent layer over one cell held as ``<Cell>_0``."""

    CELL = "LSTMCell_0"

    def __init__(self, output_dim: int = 1,
                 activation: Union[str, Callable] = "tanh",
                 inner_activation: Union[str, Callable] = "hard_sigmoid",
                 return_sequences: bool = False, go_backwards: bool = False,
                 W_regularizer: Any = None, U_regularizer: Any = None,
                 b_regularizer: Any = None, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.config = dict(output_dim=output_dim, activation=activation,
                           inner_activation=inner_activation,
                           return_sequences=return_sequences,
                           go_backwards=go_backwards,
                           input_shape=input_shape, name=name)
        self.output_dim = output_dim
        self.activation, self.inner_activation = activation, inner_activation
        self.return_sequences, self.go_backwards = (return_sequences,
                                                    go_backwards)
        self.W_regularizer, self.U_regularizer, self.b_regularizer = (
            W_regularizer, U_regularizer, b_regularizer)
        self.add_module(self.CELL, self._cell(output_dim, activation,
                                              inner_activation))

    def _cell(self, units, activation, inner_activation) -> nn.Module:
        raise NotImplementedError

    def forward(self, x):
        out, _ = getattr(self, self.CELL)(x, reverse=self.go_backwards)
        if self.return_sequences:
            return out
        # outputs are in input order, so the final processed step sits at
        # index 0 when scanning backwards
        return out[:, 0] if self.go_backwards else out[:, -1]


class SimpleRNN(_Recurrent):
    CELL = "SimpleCell_0"

    def __init__(self, output_dim: int = 1,
                 activation: Union[str, Callable] = "tanh",
                 return_sequences: bool = False, go_backwards: bool = False,
                 W_regularizer: Any = None, U_regularizer: Any = None,
                 b_regularizer: Any = None, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(output_dim, activation, None, return_sequences,
                         go_backwards, W_regularizer, U_regularizer,
                         b_regularizer, input_shape, name)
        del self.config["inner_activation"]

    def _cell(self, units, activation, inner_activation):
        return SimpleCell(None, units, activation)


class LSTM(_Recurrent):
    CELL = "LSTMCell_0"

    def _cell(self, units, activation, inner_activation):
        return LSTMCell(None, units, activation, inner_activation)


class GRU(_Recurrent):
    CELL = "GRUCell_0"

    def _cell(self, units, activation, inner_activation):
        return GRUCell(None, units, activation, inner_activation)


class ConvLSTM2D(Layer):
    """Input ``(batch, time, channels, rows, cols)`` for
    ``dim_ordering="th"``, ``(batch, time, rows, cols, channels)`` for
    ``"tf"``; a square ``nb_kernel`` kernel. ``border_mode`` and
    ``subsample`` are accepted and, as in the JAX package, unused: the
    cell's convolutions are SAME at stride 1."""

    def __init__(self, nb_filter: int = 1, nb_kernel: int = 3,
                 return_sequences: bool = False, go_backwards: bool = False,
                 border_mode: str = "same",
                 subsample: Tuple[int, int] = (1, 1),
                 dim_ordering: str = "th", input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.config = dict(nb_filter=nb_filter, nb_kernel=nb_kernel,
                           return_sequences=return_sequences,
                           go_backwards=go_backwards,
                           border_mode=border_mode, subsample=subsample,
                           dim_ordering=dim_ordering,
                           input_shape=input_shape, name=name)
        self.return_sequences, self.go_backwards = (return_sequences,
                                                    go_backwards)
        self.dim_ordering = dim_ordering
        self.nb_filter, self.nb_kernel = nb_filter, nb_kernel
        self.border_mode, self.subsample = border_mode, subsample
        self.ConvLSTMCell_0 = ConvLSTMCell(nb_filter, (nb_kernel, nb_kernel))

    def forward(self, x):
        if self.dim_ordering != "th":      # (b, t, h, w, c) -> (b, t, c, h, w)
            x = x.movedim(-1, 2)
        out, _ = self.ConvLSTMCell_0(x, reverse=self.go_backwards)
        if not self.return_sequences:
            out = out[:, 0] if self.go_backwards else out[:, -1]
            return out if self.dim_ordering == "th" else out.movedim(1, -1)
        return out if self.dim_ordering == "th" else out.movedim(2, -1)


class Bidirectional(Layer):
    """Runs ``layer`` and a copy of it with ``go_backwards=True`` (flax's
    names: ``layer`` and ``layer_bwd``, the copy drawn afresh) and merges
    their outputs by ``merge_mode``: ``concat``, ``sum``, ``mul`` or
    ``ave``."""

    def __init__(self, layer: nn.Module = None, merge_mode: str = "concat",
                 input_shape: Any = None, name: Optional[str] = None):
        super().__init__(input_shape, name)
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        self.merge_mode = merge_mode
        self.layer = layer
        config = getattr(layer, "config", None)
        if config is not None:
            self.layer_bwd = type(layer)(**{**config, "go_backwards": True})
        else:
            self.layer_bwd = copy.deepcopy(layer)
            self.layer_bwd.go_backwards = True

    def forward(self, x):
        yf, yb = self.layer(x), self.layer_bwd(x)
        if self.merge_mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge_mode == "sum":
            return yf + yb
        if self.merge_mode == "mul":
            return yf * yb
        return (yf + yb) / 2.0


class TimeDistributed(Layer):
    """Applies ``layer`` to every timestep with one set of weights (the
    batch and time axes folded together)."""

    def __init__(self, layer: nn.Module = None, input_shape: Any = None,
                 name: Optional[str] = None):
        super().__init__(input_shape, name)
        self.layer = layer

    def forward(self, x):
        b, t = x.shape[0], x.shape[1]
        y = self.layer(x.reshape((b * t,) + tuple(x.shape[2:])))
        return y.reshape((b, t) + tuple(y.shape[1:]))

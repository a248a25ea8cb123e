"""Recurrent layers — the counterpart of ``paddle_tpu/nn/rnn.py``:
``SimpleRNN``, ``LSTM`` and ``GRU`` (multi-layer, ``direction``
``"forward"`` or ``"bidirect"`` / ``"bidirectional"``) over the fused
``rnn`` op (:func:`~paddle_tpu_torch.ops.rnn_ops.rnn`), and the
single-step ``LSTMCell`` / ``GRUCell`` over a one-layer stack, as the
reference builds them. Inputs are ``[batch, seq, in]``;
``initial_states`` is ``h0`` (``[L*D, b, h]``), or ``(h0, c0)`` for the
LSTM, and ``sequence_length`` per-row lengths. Parameters
``weight_ih_l{k}[_rev]``, ``weight_hh_*``, ``bias_ih_*``, ``bias_hh_*``
are drawn U(-1/sqrt(h), 1/sqrt(h)) on ``device`` (None: CUDA) from
``generator`` (None: one seeded with 0), and carry across from the JAX
package by name. ``dropout`` is taken and, as in the reference, not
applied between layers; the parameter attributes raise (ROADMAP A7.5).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device, resolve_generator
from ..ops import rnn_ops
from .layers_common import _wants


class _RNNBase(nn.Module):
    MODE = "LSTM"
    GATES = 4

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 dropout: float = 0.0, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, *, device=None, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"bad direction {direction!r}")
        for name, attr in (("weight_ih_attr", weight_ih_attr),
                           ("weight_hh_attr", weight_hh_attr),
                           ("bias_ih_attr", bias_ih_attr),
                           ("bias_hh_attr", bias_hh_attr)):
            _wants(name, attr)
        device = resolve_device(device)
        generator = resolve_generator(device, generator)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.bidirectional = direction != "forward"
        ndir = 2 if self.bidirectional else 1
        k = 1.0 / math.sqrt(hidden_size)
        g = self.GATES
        self._names = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * ndir
            for d in range(ndir):
                sfx = f"_l{layer}" + ("_rev" if d else "")
                shapes = ([g * hidden_size, in_sz],
                          [g * hidden_size, hidden_size],
                          [g * hidden_size], [g * hidden_size])
                for n, shape in zip(("weight_ih", "weight_hh", "bias_ih",
                                     "bias_hh"), shapes):
                    w = torch.empty(shape, device=device)
                    setattr(self, n + sfx, nn.Parameter(
                        w.uniform_(-k, k, generator=generator)))
                    self._names.append(n + sfx)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states = None
        if initial_states is not None:
            states = list(initial_states) if isinstance(
                initial_states, (tuple, list)) else [initial_states]
        out, state = rnn_ops.rnn(
            inputs, [getattr(self, n) for n in self._names], states,
            sequence_length, self.MODE, self.num_layers, self.bidirectional)
        if self.MODE == "LSTM":
            return out, (state[0], state[1])
        return out, state[0]


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, *args, activation: str = "tanh", **kw):
        self.MODE = "RNN_RELU" if activation == "relu" else "RNN_TANH"
        super().__init__(*args, **kw)


class LSTMCell(nn.Module):
    """One LSTM step over ``inputs [b, in]``: ``(h, (h_n, c_n))``."""

    def __init__(self, input_size: int, hidden_size: int, **kw):
        super().__init__()
        self._rnn = LSTM(input_size, hidden_size, 1, **kw)
        self.hidden_size = hidden_size

    def forward(self, inputs, states=None):
        out, (h, c) = self._rnn(inputs[:, None], states)
        return out.reshape(inputs.shape[0], self.hidden_size), (h, c)


class GRUCell(nn.Module):
    """One GRU step over ``inputs [b, in]``: ``(h, h_n)``."""

    def __init__(self, input_size: int, hidden_size: int, **kw):
        super().__init__()
        self._rnn = GRU(input_size, hidden_size, 1, **kw)
        self.hidden_size = hidden_size

    def forward(self, inputs, states=None):
        out, h = self._rnn(inputs[:, None], states)
        return out.reshape(inputs.shape[0], self.hidden_size), h

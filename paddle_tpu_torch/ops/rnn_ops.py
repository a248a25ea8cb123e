"""The fused ``rnn`` op — the counterpart of ``paddle_tpu/ops/rnn_ops.py``
(``_rnn``): LSTM, GRU and the tanh / relu RNN, multi-layer and
bidirectional, over ``[batch, seq, in]`` inputs with optional per-row
lengths. The reference runs one ``lax.scan`` per layer and direction
(not a Pallas kernel); the port runs the same recurrence as a loop of
the same cell over the time axis, in the reference's weight layout
(``w_ih [G*h, in]``, ``w_hh [G*h, h]``, ``b_ih``, ``b_hh`` per layer and
direction, gates i, f, c, o for the LSTM and r, z, n for the GRU) and
its order of operations. Past a row's length the state holds and the
output is zero, so the final state is the state at the length. The
sequence ops of the same module wait for the rest of the op library
(ROADMAP A7.2).
"""

from __future__ import annotations

import torch

from ..amp.auto_cast import autocast_inputs


def _lstm_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    gates = x @ w_ih.T + h @ w_hh.T + b_ih + b_hh
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def _gru_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    gi = x @ w_ih.T + b_ih
    gh = h @ w_hh.T + b_hh
    ir, iz, inn = torch.chunk(gi, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1 - z) * n + z * h, c


def _tanh_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    return torch.tanh(x @ w_ih.T + h @ w_hh.T + b_ih + b_hh), c


def _relu_cell(x, h, c, w_ih, w_hh, b_ih, b_hh):
    return torch.relu(x @ w_ih.T + h @ w_hh.T + b_ih + b_hh), c


CELLS = {"LSTM": (_lstm_cell, 4), "GRU": (_gru_cell, 3),
         "RNN_TANH": (_tanh_cell, 1), "RNN_RELU": (_relu_cell, 1)}


def _run_direction(x, h, c, weights, cell, lengths, reverse):
    """One layer and direction over ``x [b, s, in]``: ``(out [b, s, h],
    h_final, c_final)``."""
    s = x.shape[1]
    outs = [None] * s
    for t in (range(s - 1, -1, -1) if reverse else range(s)):
        h_new, c_new = cell(x[:, t], h, c, *weights)
        if lengths is not None:
            live = (t < lengths)[:, None]
            h_new = torch.where(live, h_new, h)
            c_new = torch.where(live, c_new, c)
            outs[t] = torch.where(live, h_new, torch.zeros_like(h_new))
        else:
            outs[t] = h_new
        h, c = h_new, c_new
    return torch.stack(outs, dim=1), h, c


def rnn(inputs, weights, pre_state=None, sequence_length=None,
        mode: str = "LSTM", num_layers: int = 1, is_bidirec: bool = False):
    """The reference's ``rnn`` op: ``inputs [b, s, in]``, ``weights`` (4
    per layer and direction), ``pre_state`` (``h0 [L*D, b, h]``, and
    ``c0`` for the LSTM; zeros when None), ``sequence_length [b]``.
    Returns ``(out [b, s, D*h], [h_n] or [h_n, c_n])``."""
    cell, _ = CELLS[mode]
    ndir = 2 if is_bidirec else 1
    cast = autocast_inputs("rnn", inputs, *weights, *(pre_state or ()))
    x, weights = cast[0], list(cast[1:1 + len(weights)])
    pre = list(cast[1 + len(weights):])
    b = x.shape[0]
    hsz = weights[1].shape[1]
    h0s = pre[0] if pre else torch.zeros((num_layers * ndir, b, hsz),
                                         dtype=x.dtype, device=x.device)
    c0s = pre[1] if mode == "LSTM" and len(pre) > 1 else \
        torch.zeros_like(h0s)
    lengths = None
    if sequence_length is not None:
        lengths = torch.as_tensor(sequence_length, device=x.device)
    layer_in = x
    h_finals, c_finals = [], []
    for layer in range(num_layers):
        outs = []
        for d in range(ndir):
            idx = layer * ndir + d
            out, h_f, c_f = _run_direction(
                layer_in, h0s[idx], c0s[idx], weights[idx * 4:idx * 4 + 4],
                cell, lengths, reverse=(d == 1))
            outs.append(out)
            h_finals.append(h_f)
            c_finals.append(c_f)
        layer_in = outs[0] if ndir == 1 else torch.cat(outs, dim=-1)
    state = [torch.stack(h_finals)]
    if mode == "LSTM":
        state.append(torch.stack(c_finals))
    return layer_in, state

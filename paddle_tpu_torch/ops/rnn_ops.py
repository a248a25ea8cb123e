"""The fused ``rnn`` op — the counterpart of ``paddle_tpu/ops/rnn_ops.py``
(``_rnn``): LSTM, GRU and the tanh / relu RNN, multi-layer and
bidirectional, over ``[batch, seq, in]`` inputs with optional per-row
lengths. The reference runs one ``lax.scan`` per layer and direction
(not a Pallas kernel); the port runs the same recurrence as a loop of
the same cell over the time axis, in the reference's weight layout
(``w_ih [G*h, in]``, ``w_hh [G*h, h]``, ``b_ih``, ``b_hh`` per layer and
direction, gates i, f, c, o for the LSTM and r, z, n for the GRU) and
its order of operations. Past a row's length the state holds and the
output is zero, so the final state is the state at the length.

The registered ops of the reference's file: ``rnn`` over that loop;
``dynamic_lstm`` (the classic fluid LSTM over a pre-projected input,
gate order [candidate, input, forget, output], peephole columns
``Bias[4h:7h]``, ``is_reverse`` over each row's valid prefix); and the
twelve sequence ops (``sequence_pool``, ``_mask``, ``_softmax``,
``_reverse``, ``_expand``, ``_pad``, ``_unpad``, ``_conv``, ``_slice``,
``_concat``, ``_enumerate``, ``_expand_as``) over the padded-plus-lengths
design: static shapes, zeros past each row's length, no value-dependent
shape, so a captured step holds them. ``sequence_pool`` MAX reduces with
``amax``, whose gradient splits evenly among ties as JAX's ``max`` does.
"""

from __future__ import annotations

import torch

from ..amp.auto_cast import autocast_inputs
from .registry import np_dtype, register


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


@register("rnn", no_grad_slots=("SequenceLength",))
def _rnn(ctx, ins, attrs):
    """Inputs: Input [b, s, in]; WeightList (4 per layer and direction);
    PreState (h0 [L*D, b, h], and c0 for the LSTM); SequenceLength
    optional [b]. Outputs: Out [b, s, D*h], State (h_n, and c_n)."""
    lengths = ins["SequenceLength"][0] if ins.get("SequenceLength") \
        else None
    out, state = rnn(ins["Input"][0], list(ins["WeightList"]),
                     list(ins.get("PreState", [])) or None, lengths,
                     mode=attrs.get("mode", "LSTM"),
                     num_layers=int(attrs.get("num_layers", 1)),
                     is_bidirec=bool(attrs.get("is_bidirec", False)))
    return {"Out": [out], "State": state}


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


def _prefix_reverse_index(lengths, b, s, device):
    """Per row, the source time of a reversed valid prefix (padding stays
    in place): ``[b, s]``."""
    t = torch.arange(s, device=device)[None, :].expand(b, s)
    ln = lengths[:, None]
    return torch.where(t < ln, ln - 1 - t, t)


def _take_time(x, src):
    """``take_along_axis(x, src, axis=1)`` for ``src [b, s']`` over every
    trailing dim of ``x [b, s, ...]``."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(
        src.shape + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


@register("dynamic_lstm", no_grad_slots=("Length",))
def _dynamic_lstm(ctx, ins, attrs):
    """reference lstm_op.cc + math/detail/lstm_kernel.h:30-51 over a
    pre-projected input: Input [b, s, 4h], Weight [h, 4h], Bias [1, 4h]
    (or [1, 7h] with use_peepholes: checkI / checkF / checkO), Length
    [b]. Hidden / Cell [b, s, h], zeros past each row's length."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    bias = ins["Bias"][0].reshape(-1)
    b, s, four_h = x.shape
    h = four_h // 4
    lengths = (ins["Length"][0].reshape(-1).to(torch.int32)
               if ins.get("Length") else
               torch.full((b,), s, dtype=torch.int32, device=x.device))
    use_peepholes = bool(attrs.get("use_peepholes", True))
    is_reverse = bool(attrs.get("is_reverse", False))
    act_gate = _ACTS[attrs.get("gate_activation", "sigmoid")]
    act_cell = _ACTS[attrs.get("cell_activation", "tanh")]
    act_cand = _ACTS[attrs.get("candidate_activation", "tanh")]
    b4 = bias[:4 * h]
    if use_peepholes:
        w_ic, w_fc, w_oc = (bias[4 * h:5 * h], bias[5 * h:6 * h],
                            bias[6 * h:7 * h])
    if is_reverse:
        src = _prefix_reverse_index(lengths, b, s, x.device)
        x = _take_time(x, src)
    h_prev = torch.zeros((b, h), dtype=x.dtype, device=x.device)
    c_prev = torch.zeros_like(h_prev)
    hs, cs = [], []
    for t in range(s):
        gates = x[:, t] + h_prev @ w + b4
        g_c, g_i, g_f, g_o = torch.chunk(gates, 4, dim=-1)
        if use_peepholes:
            g_i = g_i + c_prev * w_ic
            g_f = g_f + c_prev * w_fc
        i = act_gate(g_i)
        f = act_gate(g_f)
        c_new = act_cand(g_c) * i + c_prev * f
        if use_peepholes:
            g_o = g_o + c_new * w_oc
        o = act_gate(g_o)
        h_new = o * act_cell(c_new)
        live = (t < lengths)[:, None]
        zero = torch.zeros_like(h_new)
        hs.append(torch.where(live, h_new, zero))
        cs.append(torch.where(live, c_new, zero))
        h_prev = torch.where(live, h_new, h_prev)
        c_prev = torch.where(live, c_new, c_prev)
    hs, cs = torch.stack(hs, dim=1), torch.stack(cs, dim=1)
    if is_reverse:
        hs, cs = _take_time(hs, src), _take_time(cs, src)
    return {"Hidden": [hs], "Cell": [cs]}


# ------------------------------------------------------- sequence ops
def _length_mask(lengths, seq, dtype):
    t = torch.arange(seq, dtype=torch.int32, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def _iota(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] \
        .expand(b, s)


@register("sequence_pool", no_grad_slots=("Length",))
def _sequence_pool(ctx, ins, attrs):
    """x [b, s, d] + Length [b] -> pooled [b, d]; pooltype SUM /
    AVERAGE / MAX / LAST / FIRST (sequence_pool_op.cc)."""
    x = ins["X"][0]
    lengths = ins["Length"][0]
    ptype = attrs.get("pooltype", "SUM").upper()
    mask = _length_mask(lengths, x.shape[1], x.dtype)[..., None]
    if ptype == "SUM":
        out = (x * mask).sum(dim=1)
    elif ptype in ("AVERAGE", "MEAN"):
        denom = torch.clamp_min(lengths.to(x.dtype), 1)[:, None]
        out = (x * mask).sum(dim=1) / denom
    elif ptype == "MAX":
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(mask > 0, x, torch.full_like(x, neg)),
                         dim=1)
    elif ptype == "LAST":
        idx = torch.clamp_min(lengths - 1, 0).to(torch.int64)
        out = _take_time(x, idx[:, None])[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register("sequence_mask", not_differentiable=True)
def _sequence_mask(ctx, ins, attrs):
    """lengths [b] -> mask [b, maxlen] (sequence_mask_op.cc)."""
    lengths = ins["X"][0]
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_mask requires a static maxlen > 0 "
                         "(a captured step needs static shapes)")
    dt = np_dtype(attrs.get("out_dtype", "int64"))
    return {"Y": [_length_mask(lengths.reshape(-1), maxlen, dt)]}


@register("sequence_softmax", no_grad_slots=("Length",))
def _sequence_softmax(ctx, ins, attrs):
    """Masked softmax over the time axis (sequence_softmax_op.cc)."""
    x = ins["X"][0]
    lengths = ins["Length"][0]
    mask = _length_mask(lengths, x.shape[1], torch.float32)
    logits = torch.where(mask > 0, x.to(torch.float32),
                         torch.full_like(mask, torch.finfo(
                             torch.float32).min))
    probs = torch.softmax(logits, dim=1) * mask
    return {"Out": [probs.to(x.dtype)]}


@register("sequence_reverse", no_grad_slots=("Length",))
def _sequence_reverse(ctx, ins, attrs):
    """Reverse each row's first ``length`` steps in place
    (sequence_reverse_op.h)."""
    x = ins["X"][0]
    lengths = ins["Length"][0]
    src = _prefix_reverse_index(lengths.reshape(-1), x.shape[0],
                                x.shape[1], x.device)
    return {"Out": [_take_time(x, src)]}


@register("sequence_expand", no_grad_slots=("RepeatTimes",))
def _sequence_expand(ctx, ins, attrs):
    """Static-ratio expand: each row repeated ``times`` times (the
    fixed-ratio form of the reference's LoD-driven op)."""
    return {"Out": [torch.repeat_interleave(ins["X"][0],
                                            int(attrs.get("times", 1)),
                                            dim=0)]}


@register("sequence_pad", no_grad_slots=("Length",))
def _sequence_pad(ctx, ins, attrs):
    """Packed rows [total, d] + Length [b] -> padded [b, maxlen, d] and
    the Length clamped to ``padded_length`` (sequence_pad_op.cc over the
    packed layout); positions past a length take PadValue."""
    x = ins["X"][0]
    lengths = ins["Length"][0].reshape(-1)
    pad = ins.get("PadValue")
    pad_value = pad[0] if pad else torch.zeros((), dtype=x.dtype,
                                              device=x.device)
    maxlen = int(attrs.get("padded_length", -1))
    if maxlen <= 0:
        raise ValueError("sequence_pad requires a static padded_length "
                         "(a captured step needs static shapes)")
    b = lengths.shape[0]
    starts = torch.cumsum(lengths, 0) - lengths
    clamped = torch.clamp_max(lengths, maxlen)
    t = _iota(b, maxlen, x.device)
    src = torch.clamp(starts[:, None] + t, 0, x.shape[0] - 1).to(torch.int64)
    gathered = x[src]
    mask = (t < clamped[:, None]).reshape((b, maxlen) + (1,) * (x.dim() - 1))
    out = torch.where(mask, gathered, pad_value.to(x.dtype))
    return {"Out": [out], "Length": [clamped]}


@register("sequence_unpad", no_grad_slots=("Length",))
def _sequence_unpad(ctx, ins, attrs):
    """Padded [b, s, d] + Length [b] -> packed [b*s, d], the valid rows
    compacted to the front in order and zeros after, and the count
    (Total): the packed buffer keeps the static ``b*s`` bound."""
    x = ins["X"][0]
    lengths = ins["Length"][0].reshape(-1)
    b, s = x.shape[0], x.shape[1]
    valid = (_iota(b, s, x.device) < lengths[:, None]).reshape(-1)
    order = torch.argsort(torch.where(valid, 0, 1), stable=True)
    flat = x.reshape((b * s,) + tuple(x.shape[2:]))
    packed = torch.where(valid[order].reshape((-1,) + (1,) * (x.dim() - 2)),
                         flat[order], torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return {"Out": [packed], "Total": [valid.sum().to(torch.int64)]}


@register("sequence_conv", no_grad_slots=("Length",))
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (sequence_conv_op.cc): x
    [b, s, d], Filter [context_length*d, m] -> [b, s, m]; window rows
    outside [0, length) contribute zeros."""
    x = ins["X"][0]
    w = ins["Filter"][0]
    lengths = ins.get("Length", [None])[0]
    cl = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    cs = int(attrs.get("contextStart", attrs.get("context_start",
                                                 -(cl - 1) // 2)))
    if int(attrs.get("contextStride", 1)) != 1:
        raise ValueError("sequence_conv only supports contextStride=1 "
                         "(the reference has the same restriction)")
    b, s, d = x.shape
    t = _iota(b, s, x.device)
    valid = (torch.ones((b, s), dtype=torch.bool, device=x.device)
             if lengths is None else t < lengths.reshape(-1)[:, None])
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xm = torch.where(valid[..., None], x, zero)
    cols = []
    for k in range(cl):
        shift = cs + k
        rolled = torch.roll(xm, -shift, dims=1)
        inb = (t + shift >= 0) & (t + shift < s)
        cols.append(torch.where(inb[..., None], rolled, zero))
    windows = torch.cat(cols, dim=-1)
    out = (windows.reshape(b * s, cl * d) @ w).reshape(b, s, -1)
    return {"Out": [torch.where(valid[..., None], out, zero)]}


@register("sequence_slice", no_grad_slots=("Offset", "Length"))
def _sequence_slice(ctx, ins, attrs):
    """Per-row slice [offset, offset + length) of each sequence, moved to
    the front with zeros after (sequence_slice_op.h)."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).to(torch.int64)
    ln = ins["Length"][0].reshape(-1).to(torch.int64)
    b, s = x.shape[0], x.shape[1]
    t = _iota(b, s, x.device)
    src = torch.clamp(off[:, None] + t, 0, s - 1)
    mask = (t < ln[:, None]).reshape((b, s) + (1,) * (x.dim() - 2))
    return {"Out": [torch.where(mask, _take_time(x, src),
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))]}


@register("sequence_concat", no_grad_slots=("Length",))
def _sequence_concat(ctx, ins, attrs):
    """Ragged concat along time (sequence_concat_op.cc): each output row
    is ``x1[:l1] ++ x2[:l2] ++ ...`` then zeros; the time bound is the
    sum of the inputs'."""
    xs = ins["X"]
    lens = [ln.reshape(-1) for ln in ins["Length"]]
    b = xs[0].shape[0]
    s_total = sum(x.shape[1] for x in xs)
    tail = (1,) * (xs[0].dim() - 2)
    t = _iota(b, s_total, xs[0].device)
    out = torch.zeros((b, s_total) + tuple(xs[0].shape[2:]),
                      dtype=xs[0].dtype, device=xs[0].device)
    start = torch.zeros((b,), dtype=torch.int32, device=xs[0].device)
    for x, ln in zip(xs, lens):
        ln = ln.to(torch.int32)
        rel = t - start[:, None]
        inseg = (rel >= 0) & (rel < ln[:, None])
        src = torch.clamp(rel, 0, x.shape[1] - 1).to(torch.int64)
        out = torch.where(inseg.reshape((b, s_total) + tail),
                          _take_time(x, src), out)
        start = start + ln
    total = sum(ln.to(torch.int64) for ln in lens)
    return {"Out": [out], "Length": [total]}


@register("sequence_enumerate", not_differentiable=True)
def _sequence_enumerate(ctx, ins, attrs):
    """Sliding windows of ids (sequence_enumerate_op.cc): x [b, s] ->
    [b, s, win_size]; positions past the row (or its length) take
    pad_value."""
    x = ins["X"][0]
    win = int(attrs.get("win_size", 2))
    pad = int(attrs.get("pad_value", 0))
    lengths = ins.get("Length", [None])[0]
    b, s = x.shape
    t = torch.arange(s, device=x.device)[None, :, None]
    k = torch.arange(win, device=x.device)[None, None, :]
    src = (t + k).expand(b, s, win)
    limit = (lengths.reshape(-1)[:, None, None] if lengths is not None
             else torch.full((b, 1, 1), s, device=x.device))
    vals = torch.gather(x[:, :, None].expand(b, s, win), 1,
                        torch.clamp(src, 0, s - 1))
    return {"Out": [torch.where(src < limit, vals,
                                torch.full_like(vals, pad))]}


@register("sequence_expand_as", no_grad_slots=("Length",))
def _sequence_expand_as(ctx, ins, attrs):
    """Per-row features broadcast over time (sequence_expand_as_op.cc):
    x [b, d] + Length [b] -> [b, maxlen, d] masked to each row's
    length."""
    x = ins["X"][0]
    lengths = ins["Length"][0].reshape(-1)
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen <= 0:
        raise ValueError("sequence_expand_as requires a static maxlen")
    out = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    mask = _length_mask(lengths, maxlen, x.dtype).reshape(
        (x.shape[0], maxlen) + (1,) * (x.dim() - 1))
    return {"Out": [out * mask]}

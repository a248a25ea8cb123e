"""Structured-prediction and legacy recurrent op lowerings — the sequence
half of ``paddle_tpu/ops/structured_ops.py`` (``:62-413``).

Ported: ``gru_unit``, ``gru``, ``lstm_unit``, ``lstm``, ``lstmp``,
``warpctc``, ``linear_chain_crf`` and ``crf_decoding`` (Viterbi). The
reference scans each recurrence with ``lax.scan``; the port runs the same
step as a loop over time, each step the reference's order of
operations. CTC and the CRF run their forward algorithms in log space,
as the reference does, and take their gradients through the generic
grad (which re-runs the loop under autograd: ROADMAP B, later perf
work). ``warpctc``'s loss is the reference's alpha recursion and
``norm_by_times``, not ``torch.nn.functional.ctc_loss``'s conventions;
its ``WarpCTCGrad`` output is the reference's zeros. Viterbi picks the
first maximum (``torch.argmax``, as ``jnp.argmax``) at ties.

The conv half (``:415-532``): ``conv3d_transpose`` and
``depthwise_conv2d_transpose`` (torch's transposed convolutions, cropped
to the reference's padding), ``deformable_conv`` (DCNv2, modulated) and
``deformable_conv_v1`` (bilinear samples at the offset taps, zero
outside the image, then one contraction with the filter; the offsets'
gradient flows through the bilinear weights) and ``fsp``.

The reference's inputs with LoD become dense ``[B, T, ...]`` batches with
explicit lengths, as everywhere in the port.
"""

from __future__ import annotations

import torch

from .registry import register


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh,
            "relu": torch.relu, "identity": lambda x: x}[name]


_ACT_IDS = ["identity", "sigmoid", "tanh", "relu"]


# ---------------------------------------------------------------------------
# GRU family (pre-projected inputs, reference gru_unit_op.h:53-120)
# ---------------------------------------------------------------------------


def _gru_step(x_t, h_prev, weight, bias, act_gate, act_node, origin_mode):
    """x_t (B, 3D) pre-projected; weight a flat (D*3D) buffer read as
    the reference's GEMMs read it: the first 2*D*D elements the
    update/reset weights viewed (D, 2D), the rest the candidate weight
    (D, D) — not a column slice of a (D, 3D) view."""
    d = h_prev.shape[1]
    flat = weight.reshape(-1)
    w_ur = flat[:2 * d * d].reshape(d, 2 * d)
    w_c = flat[2 * d * d:].reshape(d, d)
    g = x_t + (bias if bias is not None else 0.0)
    g_ur = g[:, :2 * d] + h_prev @ w_ur
    u = act_gate(g_ur[:, :d])
    r = act_gate(g_ur[:, d:])
    rhp = r * h_prev
    c = act_node(g[:, 2 * d:] + rhp @ w_c)
    if origin_mode:
        h = (1.0 - u) * c + u * h_prev
    else:
        h = u * c + (1.0 - u) * h_prev
    return h, torch.cat([u, r, c], dim=1), rhp


@register("gru_unit", no_grad_slots=())
def _gru_unit(ctx, ins, attrs):
    """reference gru_unit_op.h:53-120: one GRU step on a pre-projected
    x."""
    h, gate, rhp = _gru_step(
        ins["Input"][0], ins["HiddenPrev"][0], ins["Weight"][0],
        ins.get("Bias", [None])[0],
        _act(_ACT_IDS[int(attrs.get("gate_activation", 1))]),
        _act(_ACT_IDS[int(attrs.get("activation", 2))]),
        bool(attrs.get("origin_mode", False)))
    return {"Hidden": [h], "Gate": [gate], "ResetHiddenPrev": [rhp]}


def _act_attr(attrs, key, default, default_id):
    v = attrs.get(key, default)
    return _act(v if isinstance(v, str) else _ACT_IDS[int(
        attrs.get(key, default_id))])


def _time_loop(x, reverse, step):
    """Run ``step(x_t)`` over time (reversed when asked) and stack each
    of its outputs back in time order along dim 1."""
    t_len = x.shape[1]
    order = range(t_len - 1, -1, -1) if reverse else range(t_len)
    outs = [None] * t_len
    for t in order:
        outs[t] = step(x[:, t])
    return [torch.stack(v, dim=1) for v in zip(*outs)]


@register("gru", no_grad_slots=())
def _gru(ctx, ins, attrs):
    """reference gru_op.cc, dense: Input (B, T, 3D) pre-projected, run
    with the gru_unit cell."""
    x = ins["Input"][0]
    weight = ins["Weight"][0]
    bias = ins.get("Bias", [None])[0]
    h0 = ins.get("H0", [None])[0]
    act_gate = _act_attr(attrs, "gate_activation", "sigmoid", 1)
    act_node = _act_attr(attrs, "activation", "tanh", 2)
    origin = bool(attrs.get("origin_mode", False))
    d = weight.shape[0]
    state = [h0 if h0 is not None else torch.zeros(
        (x.shape[0], d), dtype=x.dtype, device=x.device)]

    def step(x_t):
        h_new, gate, rhp = _gru_step(x_t, state[0], weight, bias, act_gate,
                                     act_node, origin)
        state[0] = h_new
        return h_new, gate, rhp

    hs, gates, rhps = _time_loop(x, bool(attrs.get("is_reverse", False)),
                                 step)
    return {"Hidden": [hs], "BatchGate": [gates],
            "BatchResetHiddenPrev": [rhps], "BatchHidden": [hs]}


# ---------------------------------------------------------------------------
# LSTM family
# ---------------------------------------------------------------------------


@register("lstm_unit", no_grad_slots=())
def _lstm_unit(ctx, ins, attrs):
    """reference lstm_unit_op.h:61-77: gates packed (i, f, o, g)."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    fb = attrs.get("forget_bias", 0.0)
    d = c_prev.shape[1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + fb)
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    g = torch.tanh(x[:, 3 * d:])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


def _lstm_step(x_t, h_prev, c_prev, weight, bias, checks, acts, proj=None):
    """reference math/detail/lstm_kernel.h:30-51: gates (c~, i, f, o)
    with peephole checks; an optional recurrent projection
    (lstmp_op.cc)."""
    act_node, act_gate, act_state = acts
    d = c_prev.shape[1]
    g = x_t + h_prev @ weight
    if bias is not None:
        g = g + bias
    cand = act_node(g[:, :d])
    ci, cf, co = checks
    i = act_gate(g[:, d:2 * d] + (c_prev * ci if ci is not None else 0.0))
    f = act_gate(g[:, 2 * d:3 * d] + (c_prev * cf if cf is not None
                                      else 0.0))
    c = cand * i + c_prev * f
    o = act_gate(g[:, 3 * d:] + (c * co if co is not None else 0.0))
    h = o * act_state(c)
    if proj is not None:
        h = h @ proj
    return h, c, g


def _lstm_common(ins, attrs, projected):
    x = ins["Input"][0]
    weight = ins["Weight"][0]
    bias = ins.get("Bias", [None])[0]
    proj = ins["ProjWeight"][0] if projected else None
    h0 = ins.get("H0", [None])[0]
    c0 = ins.get("C0", [None])[0]
    peephole = bool(attrs.get("use_peepholes", True))
    acts = (_act(attrs.get("candidate_activation", "tanh")),
            _act(attrs.get("gate_activation", "sigmoid")),
            _act(attrs.get("cell_activation", "tanh")))
    b, d = x.shape[0], x.shape[2] // 4
    checks = (None, None, None)
    if bias is not None:
        bias = bias.reshape(-1)
        if peephole and bias.shape[0] == 7 * d:
            checks = (bias[4 * d:5 * d], bias[5 * d:6 * d], bias[6 * d:])
        bias = bias[:4 * d]
    psize = proj.shape[1] if projected else d
    state = [h0 if h0 is not None else torch.zeros(
        (b, psize), dtype=x.dtype, device=x.device),
        c0 if c0 is not None else torch.zeros(
            (b, d), dtype=x.dtype, device=x.device)]

    def step(x_t):
        h2, c2, g = _lstm_step(x_t, state[0], state[1], weight, bias, checks,
                               acts, proj)
        state[0], state[1] = h2, c2
        return h2, c2, g

    hs, cs, gs = _time_loop(x, bool(attrs.get("is_reverse", False)), step)
    out = {"Hidden": [hs], "Cell": [cs], "BatchGate": [gs],
           "BatchCellPreAct": [cs]}
    if projected:
        out["Projection"] = out.pop("Hidden")
        out["BatchHidden"] = [hs]
    return out


@register("lstm", no_grad_slots=())
def _lstm(ctx, ins, attrs):
    """reference lstm_op.cc, dense: Input (B, T, 4D) pre-projected."""
    return _lstm_common(ins, attrs, projected=False)


@register("lstmp", no_grad_slots=())
def _lstmp(ctx, ins, attrs):
    """reference lstmp_op.cc: the LSTM with a recurrent projection."""
    return _lstm_common(ins, attrs, projected=True)


# ---------------------------------------------------------------------------
# CTC (warpctc): the log-space forward algorithm
# ---------------------------------------------------------------------------

_NEG = -1e30


def _shift_right(a, k, fill):
    """``pad(a, ((0, 0), (k, 0)), fill)[:, :s]``."""
    return torch.cat([torch.full_like(a[:, :k], fill), a[:, :-k]], dim=1)


@register("warpctc", no_grad_slots=("Label", "LogitsLength", "LabelLength"),
          nondiff_outputs=("WarpCTCGrad",))
def _warpctc(ctx, ins, attrs):
    """reference warpctc_op.cc: the CTC loss. Logits (B, T, C) raw
    activations, Label (B, L) padded with ``blank``, LogitsLength and
    LabelLength (B,). Loss (B, 1) from the alpha recursion in log
    space."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].to(torch.int64)
    blank = int(attrs.get("blank", 0))
    norm_by_times = bool(attrs.get("norm_by_times", False))
    b, t, c = logits.shape
    l_ = label.shape[1]
    dev = logits.device
    logit_len = ins.get("LogitsLength", [None])[0]
    label_len = ins.get("LabelLength", [None])[0]
    logit_len = (torch.full((b,), t, dtype=torch.int64, device=dev)
                 if logit_len is None else logit_len.reshape(-1).long())
    label_len = (torch.full((b,), l_, dtype=torch.int64, device=dev)
                 if label_len is None else label_len.reshape(-1).long())
    logp = torch.log_softmax(logits, dim=-1)
    # the extended label: blank, l1, blank, l2, ... blank (2L + 1)
    s = 2 * l_ + 1
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = label
    can_skip = (ext != blank) & (ext != _shift_right(ext, 2, -1))
    neg = torch.full((b, s), _NEG, dtype=logp.dtype, device=dev)
    first_lab = torch.gather(logp[:, 0], 1, ext[:, 1:2])[:, 0]
    a0 = torch.cat([logp[:, 0, blank:blank + 1],
                    torch.where(label_len > 0, first_lab,
                                torch.full_like(first_lab, _NEG))[:, None],
                    neg[:, 2:]], dim=1)
    alpha = a0
    for ti in range(1, t):
        shift1 = _shift_right(alpha, 1, _NEG)
        shift2 = torch.where(can_skip, _shift_right(alpha, 2, _NEG), neg)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        new = merged + torch.gather(logp[:, ti], 1, ext)
        alpha = torch.where((ti < logit_len)[:, None], new, alpha)
    send = 2 * label_len
    a_last = torch.gather(alpha, 1, send[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp_min(send - 1, 0)[:, None])[:, 0]
    a_prev = torch.where(label_len > 0, a_prev, torch.full_like(a_prev, _NEG))
    loss = -torch.logaddexp(a_last, a_prev)
    if norm_by_times:
        loss = loss / logit_len.to(loss.dtype)
    return {"Loss": [loss[:, None]],
            "WarpCTCGrad": [torch.zeros_like(logits)]}


# ---------------------------------------------------------------------------
# Linear-chain CRF, log space
# ---------------------------------------------------------------------------


def _crf_inputs(ins):
    emission = ins["Emission"][0]
    transition = ins["Transition"][0]
    b, t, _ = emission.shape
    length = ins.get("Length", [None])[0]
    length = (torch.full((b,), t, dtype=torch.int64, device=emission.device)
              if length is None else length.reshape(-1).long())
    return emission, transition, length


@register("linear_chain_crf", no_grad_slots=("Label", "Length"))
def _linear_chain_crf(ctx, ins, attrs):
    """reference linear_chain_crf_op.h:54-220: Emission (B, T, K),
    Transition (K+2, K) (row 0 the start weights, row 1 the end
    weights), Label (B, T), Length (B,). LogLikelihood = logZ - gold
    score, the negative log likelihood the reference emits; Alpha in
    log space."""
    emission, transition, length = _crf_inputs(ins)
    label = ins["Label"][0].reshape(emission.shape[:2]).long()
    b, t, k = emission.shape
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    alphas = [start_w[None, :] + emission[:, 0]]
    for ti in range(1, t):
        alpha = alphas[-1]
        new = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) + \
            emission[:, ti]
        alphas.append(torch.where((ti < length)[:, None], new, alpha))
    logz = torch.logsumexp(alphas[-1] + end_w[None, :], dim=1)
    t_range = torch.arange(t, device=emission.device)
    valid = t_range[None, :] < length[:, None]
    em_gold = torch.gather(emission, 2, label[:, :, None])[:, :, 0]
    em_score = torch.sum(em_gold * valid, dim=1)
    tr_gold = trans[label[:, :-1], label[:, 1:]]
    tr_score = torch.sum(tr_gold * (t_range[None, 1:] < length[:, None]),
                         dim=1)
    last = torch.gather(label, 1, (length - 1)[:, None])[:, 0]
    gold = em_score + tr_score + start_w[label[:, 0]] + end_w[last]
    return {"LogLikelihood": [(logz - gold)[:, None]],
            "Alpha": [torch.stack(alphas, dim=1)],
            "EmissionExps": [torch.exp(emission)],
            "TransitionExps": [torch.exp(transition)]}


@register("crf_decoding", not_differentiable=True)
def _crf_decoding(ctx, ins, attrs):
    """reference crf_decoding_op.h: Viterbi under the linear_chain_crf
    Transition convention. Emission (B, T, K), Length (B,) ->
    ViterbiPath (B, T) int64, zero past each row's length; with Label,
    the 0/1 correctness mask the reference emits instead. The path is
    the reference's backtrack position for position, its shift by one
    included (position t holds the state at t + 1; ROADMAP C)."""
    emission, transition, length = _crf_inputs(ins)
    b, t, k = emission.shape
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    ident = torch.arange(k, device=emission.device)[None, :]
    alpha = start_w[None, :] + emission[:, 0]
    backptrs = []
    for ti in range(1, t):
        scores = alpha[:, :, None] + trans[None]
        best_prev = torch.argmax(scores, dim=1)
        new = torch.amax(scores, dim=1) + emission[:, ti]
        live = (ti < length)[:, None]
        alpha = torch.where(live, new, alpha)
        # finished rows point back to themselves
        backptrs.append(torch.where(live, best_prev, ident))
    last = torch.argmax(alpha + end_w[None, :], dim=1)
    # the reference's lax.scan backtrack emits each step's carry before
    # it steps back, then appends the last state once more
    cur, path_rev = last, []
    for bp in reversed(backptrs):
        path_rev.append(cur)
        cur = torch.gather(bp, 1, cur[:, None])[:, 0]
    path = torch.stack(path_rev[::-1] + [last], dim=1).to(torch.int64)
    valid = torch.arange(t, device=emission.device)[None, :] < length[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=emission.device)
    path = torch.where(valid, path, zero)
    label = ins.get("Label", [None])[0]
    if label is not None:
        correct = path == label.reshape(b, t).to(torch.int64)
        path = torch.where(valid, correct.to(torch.int64), zero)
    return {"ViterbiPath": [path]}


# ---------------------------------------------------------------------------
# conv transpose variants + deformable conv
# ---------------------------------------------------------------------------


@register("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    from .nn_ops import _conv_padding, _transpose_pad, conv_transpose
    x, w = ins["Input"][0], ins["Filter"][0]  # w: [in, out, kd, kh, kw]
    strides = [int(s) for s in attrs.get("strides", [1, 1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1, 1])]
    if int(attrs.get("groups", 1)) != 1:
        raise NotImplementedError("grouped conv3d_transpose")
    pad = _transpose_pad(_conv_padding(attrs.get("paddings", [0, 0, 0]), 3),
                         w.shape[2:], strides, dil)
    return {"Output": [conv_transpose(x, w, strides, pad, dil, 1)]}


@register("depthwise_conv2d_transpose")
def _depthwise_conv2d_transpose(ctx, ins, attrs):
    """Depthwise transposed convolution: filter [C, 1, kh, kw], one group
    per channel."""
    from .nn_ops import _conv_padding, conv_transpose
    x, w = ins["Input"][0], ins["Filter"][0]
    s = [int(v) for v in attrs.get("strides", [1, 1])]
    pads = _conv_padding(attrs.get("paddings", [0, 0]), 2)
    dil = [int(v) for v in attrs.get("dilations", [1, 1])]
    return {"Output": [conv_transpose(x, w, s, pads, dil, x.shape[1])]}


def _deform_sample(x, py, px):
    """Bilinear samples of x (N,C,H,W) at float coords ``(N, Ho, Wo)``;
    zero outside the image."""
    from .image_ops import _gather_hw
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    wy = (py - y0).to(x.dtype)[:, None]
    wx = (px - x0).to(x.dtype)[:, None]
    return (_gather_hw(x, y0, x0) * (1 - wy) * (1 - wx)
            + _gather_hw(x, y0, x0 + 1) * (1 - wy) * wx
            + _gather_hw(x, y0 + 1, x0) * wy * (1 - wx)
            + _gather_hw(x, y0 + 1, x0 + 1) * wy * wx)


def _deformable_conv_impl(ins, attrs, modulated):
    x = ins["Input"][0]
    offset = ins["Offset"][0]                     # (N, 2*kh*kw, Ho, Wo)
    w = ins["Filter"][0]                          # (out, in, kh, kw)
    mask = ins["Mask"][0] if modulated else None  # (N, kh*kw, Ho, Wo)
    s = [int(v) for v in attrs.get("strides", [1, 1])]
    p = [int(v) for v in attrs.get("paddings", [0, 0])]
    d = [int(v) for v in attrs.get("dilations", [1, 1])]
    dg = int(attrs.get("deformable_groups", 1))
    if int(attrs.get("groups", 1)) != 1 or dg != 1:
        raise NotImplementedError("grouped/multi-group deformable_conv")
    n, c, h, wd = x.shape
    co, ci, kh, kw = w.shape
    ho = (h + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    wo = (wd + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    base_y = (torch.arange(ho, device=x.device) * s[0] - p[0])[None, :, None]
    base_x = (torch.arange(wo, device=x.device) * s[1] - p[1])[None, None, :]
    off = offset.reshape(n, kh * kw, 2, ho, wo)
    cols = []
    for i in range(kh):
        for j in range(kw):
            kidx = i * kw + j
            py = base_y + i * d[0] + off[:, kidx, 0]
            px = base_x + j * d[1] + off[:, kidx, 1]
            samp = _deform_sample(x, py, px)      # (N,C,Ho,Wo)
            if mask is not None:
                samp = samp * mask[:, kidx][:, None]
            cols.append(samp)
    patches = torch.stack(cols, dim=2)            # (N,C,khkw,Ho,Wo)
    out = torch.einsum("nckhw,ock->nohw", patches,
                       w.reshape(co, ci, kh * kw))
    return {"Output": [out]}


@register("deformable_conv", no_grad_slots=())
def _deformable_conv(ctx, ins, attrs):
    return _deformable_conv_impl(ins, attrs, modulated=True)


@register("deformable_conv_v1", no_grad_slots=())
def _deformable_conv_v1(ctx, ins, attrs):
    return _deformable_conv_impl(ins, attrs, modulated=False)


@register("fsp")
def _fsp(ctx, ins, attrs):
    """out[n,i,j] = mean over h, w of X[n,i,h,w] * Y[n,j,h,w]."""
    x, y = ins["X"][0], ins["Y"][0]
    hw = x.shape[2] * x.shape[3]
    return {"Out": [torch.einsum("nihw,njhw->nij", x, y) / hw]}

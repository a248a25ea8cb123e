"""Loss op lowerings — the counterpart of ``paddle_tpu/ops/loss_ops.py``,
whole: ``bce_loss``, ``nll_loss``, ``log_loss``, ``rank_loss``,
``margin_rank_loss``, ``hinge_loss``, ``sigmoid_focal_loss``,
``bpr_loss``, ``center_loss``, ``cos_sim``, ``dist``, ``minus``,
``l1_norm``, ``frobenius_norm`` and ``cross_entropy2``. Every gradient
is the generic one. Where JAX's gradient at a tie or at zero differs
from torch's own function, the port takes the form whose gradient is
JAX's: ``clip`` and ``abs`` from :mod:`.math_ops`, ``logaddexp`` for
``softplus`` (torch's ``softplus`` switches to the identity above its
threshold), ``amax`` / ``amin`` for full reductions.
"""

from __future__ import annotations

import torch

from .math_ops import absolute, clip
from .registry import register

_EPS = 1e-12


@register("bce_loss", no_grad_slots=("Label",))
def _bce_loss(ctx, ins, attrs):
    """reference bce_loss_op.cc: x already through a sigmoid."""
    x = ins["X"][0]
    label = ins["Label"][0].to(x.dtype)
    x = clip(x, _EPS, 1.0 - _EPS)
    return {"Out": [-(label * torch.log(x)
                      + (1.0 - label) * torch.log1p(-x))]}


@register("nll_loss", no_grad_slots=("Label", "Weight"))
def _nll_loss(ctx, ins, attrs):
    """reference nll_loss_op.cc over log-probs: X (N, C) or (N, C, d1,
    ...), Label (N, ...), optional Weight (C,)."""
    x = ins["X"][0]
    label = ins["Label"][0].long()
    weight = ins.get("Weight", [None])[0]
    ignore_index = int(attrs.get("ignore_index", -100))
    reduction = attrs.get("reduction", "mean")
    c = x.shape[1]
    if x.dim() > 2:
        perm = (0,) + tuple(range(2, x.dim())) + (1,)
        x2 = x.permute(perm).reshape(-1, c)
    else:
        x2 = x
    lab = label.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(x2, 1, safe[:, None])[:, 0]
    w = (torch.ones((c,), dtype=x.dtype, device=x.device) if weight is None
         else weight.to(x.dtype))
    sample_w = torch.where(valid, w[safe], torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    loss = -picked * sample_w
    total_w = torch.sum(sample_w)
    if reduction == "none":
        out = loss.reshape(label.shape) if x.dim() > 2 else loss
    elif reduction == "sum":
        out = torch.sum(loss)
    else:
        out = torch.sum(loss) / torch.clamp_min(total_w, _EPS)
    return {"Out": [out], "Total_weight": [total_w]}


@register("log_loss", no_grad_slots=("Labels",))
def _log_loss(ctx, ins, attrs):
    """reference log_loss_op.cc."""
    pred = ins["Predicted"][0]
    label = ins["Labels"][0].to(pred.dtype)
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(pred + eps)
                     - (1.0 - label) * torch.log(1.0 - pred + eps)]}


@register("rank_loss", no_grad_slots=("Label",))
def _rank_loss(ctx, ins, attrs):
    """reference rank_loss_op.cc: log(1 + exp(L - R)) - label (L - R)."""
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [torch.logaddexp(torch.zeros_like(d), d)
                    - ins["Label"][0].to(d.dtype) * d]}


@register("margin_rank_loss", no_grad_slots=("Label",))
def _margin_rank_loss(ctx, ins, attrs):
    """reference margin_rank_loss_op.cc: relu(margin - label (x1 -
    x2))."""
    x1, x2 = ins["X1"][0], ins["X2"][0]
    raw = attrs.get("margin", 0.0) - ins["Label"][0].to(x1.dtype) * (x1 - x2)
    return {"Out": [torch.relu(raw)], "Activated": [(raw > 0).to(x1.dtype)]}


@register("hinge_loss", no_grad_slots=("Labels",))
def _hinge_loss(ctx, ins, attrs):
    """reference hinge_loss_op.cc: max(0, 1 - (2 label - 1) logits)."""
    logits = ins["Logits"][0]
    labels = ins["Labels"][0].to(logits.dtype)
    return {"Loss": [torch.relu(1.0 - (2.0 * labels - 1.0) * logits)]}


@register("sigmoid_focal_loss", no_grad_slots=("Label", "FgNum"))
def _sigmoid_focal_loss(ctx, ins, attrs):
    """reference detection/sigmoid_focal_loss_op.cu:34-70: X (N, C)
    logits, Label (N, 1) in {-1, 0, 1..C}, FgNum (1,)."""
    x = ins["X"][0]
    g = ins["Label"][0].reshape(-1, 1).to(torch.int32)
    fg = ins["FgNum"][0].reshape(-1)[0]
    gamma = attrs.get("gamma", 2.0)
    alpha = attrs.get("alpha", 0.25)
    c = x.shape[1]
    d = torch.arange(1, c + 1, dtype=torch.int32, device=x.device)[None, :]
    c_pos = (g == d).to(x.dtype)
    c_neg = ((g != -1) & (g != d)).to(x.dtype)
    fg_num = torch.clamp_min(fg, 1).to(x.dtype)
    p = torch.sigmoid(x)
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(
        torch.clamp_min(p, _EPS))
    pos = (x >= 0).to(x.dtype)
    term_neg = torch.pow(p, gamma) * (
        -x * pos - torch.log1p(torch.exp(x - 2.0 * x * pos)))
    return {"Out": [-c_pos * term_pos * (alpha / fg_num)
                    - c_neg * term_neg * ((1.0 - alpha) / fg_num)]}


@register("bpr_loss", no_grad_slots=("Label",))
def _bpr_loss(ctx, ins, attrs):
    """reference bpr_loss_op.h:45-80: loss[i] = mean over j != label_i
    of softplus(x[i, j] - x[i, label_i])."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    pos = torch.gather(x2, 1, label[:, None])
    diff = x2 - pos
    per = torch.logaddexp(diff, torch.zeros_like(diff))
    mask = torch.arange(c, device=x.device)[None, :] != label[:, None]
    loss = torch.sum(per * mask, dim=1, keepdim=True) / (c - 1)
    return {"Y": [loss.reshape(tuple(x.shape[:-1]) + (1,))]}


@register("center_loss",
          no_grad_slots=("Label", "Centers", "CenterUpdateRate"))
def _center_loss(ctx, ins, attrs):
    """reference center_loss_op.h:44-130: diff = x - centers[label],
    loss = |diff|^2 / 2; the centers move by the mean diff per cluster
    (counts start at 1)."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    centers = ins["Centers"][0]
    alpha = ins["CenterUpdateRate"][0].reshape(-1)[0]
    cluster_num = int(attrs.get("cluster_num", centers.shape[0]))
    diff = x - centers[label]
    loss = 0.5 * torch.sum(diff * diff, dim=1, keepdim=True)
    centers_out = centers
    if bool(attrs.get("need_update", False)):
        acc = torch.zeros_like(centers).index_add(0, label, diff)
        count = torch.ones((cluster_num,), dtype=x.dtype,
                           device=x.device).index_add(
            0, label, torch.ones_like(label, dtype=x.dtype))
        centers_out = centers + alpha.to(x.dtype) * acc / count[:, None]
    return {"Loss": [loss], "SampleCenterDiff": [diff],
            "CentersOut": [centers_out]}


@register("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """reference cos_sim_op.cc: the row-wise cosine; Y may have batch 1
    (broadcast against every row of X)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + _EPS)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register("dist")
def _dist(ctx, ins, attrs):
    """reference dist_op.cc: the p-norm of broadcast(X - Y), a
    scalar."""
    x, y = ins["X"][0], ins["Y"][0]
    p = float(attrs.get("p", 2.0))
    d = absolute(x - y)
    if p == float("inf"):
        out = torch.amax(d)
    elif p == float("-inf"):
        out = torch.amin(d)
    elif p == 0.0:
        out = torch.sum((d != 0).to(x.dtype))
    else:
        out = torch.pow(torch.sum(torch.pow(d, p)), 1.0 / p)
    return {"Out": [out]}


@register("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register("l1_norm")
def _l1_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(absolute(ins["X"][0]))]}


@register("frobenius_norm")
def _frobenius_norm(ctx, ins, attrs):
    """reference frobenius_norm_op.cc: sqrt(sum(x^2, dims))."""
    x = ins["X"][0]
    dims = attrs.get("dim", None) or attrs.get("axis", None)
    keep = bool(attrs.get("keep_dim", attrs.get("keepdim", False)))
    sq = x * x
    if attrs.get("reduce_all", False) or dims is None:
        s = torch.sum(sq)
        if keep:
            s = s.reshape((1,) * x.dim())
    else:
        axes = tuple(int(d) for d in (dims if isinstance(dims, (list, tuple))
                                      else [dims]))
        s = torch.sum(sq, dim=axes, keepdim=keep)
    return {"Out": [torch.sqrt(s)]}


@register("cross_entropy2", no_grad_slots=("Label",))
def _cross_entropy2(ctx, ins, attrs):
    """reference cross_entropy_op.cc (CrossEntropyOp2): the hard-label
    cross entropy over probabilities, and the matched probability."""
    x = ins["X"][0]
    ignore_index = int(attrs.get("ignore_index", -100))
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    lab = ins["Label"][0].reshape(-1).long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    match = torch.gather(x2, 1, safe[:, None])[:, 0]
    y = torch.where(valid, -torch.log(torch.clamp_min(match, _EPS)),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    shp = tuple(x.shape[:-1]) + (1,)
    return {"Y": [y.reshape(shp)], "MatchX": [match.reshape(shp)]}

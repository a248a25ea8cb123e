"""Neural-net op lowerings — the counterpart of
``paddle_tpu/ops/nn_ops.py`` for the ops the ported layer builders emit.

Ported: ``conv2d``, ``pool2d``, ``softmax``, ``log_softmax``,
``softmax_with_cross_entropy``, ``cross_entropy``,
``sigmoid_cross_entropy_with_logits``, ``batch_norm``, ``layer_norm``,
``dropout`` (with ``dropout_grad``), ``lookup_table_v2`` (with
``lookup_table_v2_grad``), ``lookup_table`` and ``accuracy``. Waiting
(ROADMAP A7.2): ``depthwise_conv2d``, ``conv2d_transpose``, ``conv3d``,
``squared_l2_distance``, ``huber_loss``, ``smooth_l1_loss``,
``mse_loss``, ``kldiv_loss``, ``label_smooth``, ``group_norm``,
``instance_norm``, ``norm``, ``embedding_bag``, ``auc`` and the fused
activations.

``layer_norm`` takes the reference's predicate (``nn_ops.py:362-365``:
one normalized axis, Scale and Bias, ``h % 128 == 0``,
``FLAGS_use_pallas_layer_norm``) to the LayerNorm kernels
(:mod:`.cuda.layer_norm`: ``ln_fwd``, and ``ln_bwd`` through their
autograd Function when the generic grad re-runs the op); every other
call is composed. ``conv2d`` is cuDNN: the reference's is XLA's
convolution, not a Pallas kernel. Dropout draws its mask from the op's
threefry key, as ``jax.random.bernoulli`` does with 64-bit types off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import flags, prng
from .cuda.layer_norm import fused_layer_norm_with_stats
from .math_ops import absolute
from .registry import register


# ---------------------------------------------------------------------------
# Convolution / pooling
# ---------------------------------------------------------------------------

def _conv_padding(paddings, ndim):
    """[(lo, hi)] per spatial dim, from ``[ph, pw]`` or ``[ph0, ph1,
    pw0, pw1]``."""
    if isinstance(paddings, str):
        raise NotImplementedError(
            f"string padding {paddings!r} waits for ROADMAP A7.2")
    p = list(paddings)
    if len(p) == ndim:
        return [(int(x), int(x)) for x in p]
    if len(p) == 2 * ndim:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(ndim)]
    raise ValueError(f"bad paddings {paddings}")


def _torch_pad(pad2):
    """[(lo, hi)] for H, W as ``F.pad``'s (w_lo, w_hi, h_lo, h_hi)."""
    (h0, h1), (w0, w1) = pad2
    return (w0, w1, h0, h1)


@register("conv2d", no_grad_slots=())
def _conv2d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    pad2 = _conv_padding(attrs.get("paddings", [0, 0]), 2)
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    groups = int(attrs.get("groups", 1))
    nhwc = attrs.get("data_format", "NCHW") not in ("NCHW", "AnyLayout")
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    if any(lo != hi for lo, hi in pad2):
        x = F.pad(x, _torch_pad(pad2))
        pad = 0
    else:
        pad = [lo for lo, _ in pad2]
    # the filter is OIHW in either data format (operators/conv_op.cc)
    out = F.conv2d(x, w, None, strides, pad, dil, groups)
    if nhwc:
        out = out.permute(0, 2, 3, 1)
    return {"Output": [out]}


@register("pool2d")
def _pool2d(ctx, ins, attrs):
    x = ins["X"][0]  # NCHW
    ptype = attrs.get("pooling_type", "max")
    ksize = [int(k) for k in attrs.get("ksize", [2, 2])]
    strides = [int(s) for s in attrs.get("strides", ksize)]
    paddings = attrs.get("paddings", [0, 0])
    global_pool = attrs.get("global_pooling", False)
    exclusive = attrs.get("exclusive", True)
    ceil_mode = attrs.get("ceil_mode", False)
    if attrs.get("adaptive", False):
        oh, ow = ksize
        if x.shape[2] % oh or x.shape[3] % ow:
            raise NotImplementedError(
                "adaptive pool with non-divisible sizes")
        kh, kw = x.shape[2] // oh, x.shape[3] // ow
        ksize, strides, paddings = [kh, kw], [kh, kw], [0, 0]
        global_pool = False
    if global_pool:
        ksize = [int(x.shape[2]), int(x.shape[3])]
        strides = ksize
        paddings = [0, 0]
    pad2 = _conv_padding(paddings, 2)
    if ceil_mode:
        # pad extra on the high side so the windows cover the input
        new_pad = []
        for i, (lo, hi) in enumerate(pad2):
            dim = x.shape[2 + i]
            rem = (dim + lo + hi - ksize[i]) % strides[i]
            new_pad.append((lo, hi + (strides[i] - rem) % strides[i]))
        pad2 = new_pad
    padded = any(p != (0, 0) for p in pad2)
    if ptype == "max":
        xp = F.pad(x, _torch_pad(pad2), value=float("-inf")) if padded else x
        return {"Out": [F.max_pool2d(xp, ksize, strides)]}
    xp = F.pad(x, _torch_pad(pad2)) if padded else x
    summed = F.avg_pool2d(xp, ksize, strides, divisor_override=1)
    if exclusive and padded:
        ones = F.pad(torch.ones_like(x), _torch_pad(pad2))
        counts = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
        return {"Out": [summed / counts]}
    return {"Out": [summed / float(np.prod(ksize))]}


# ---------------------------------------------------------------------------
# Softmax / losses
# ---------------------------------------------------------------------------

@register("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


@register("softmax_with_cross_entropy", no_grad_slots=("Label",),
          nondiff_outputs=("Softmax",))
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        # label == ignore_index is masked for any value; the clamp keeps
        # an out-of-range index out of the gather (the reference's rule)
        valid = lbl != attrs.get("ignore_index", -100)
        n_class = logits.shape[axis]
        safe = torch.clamp(torch.where(valid, lbl, torch.zeros_like(lbl)),
                           0, n_class - 1)
        picked = torch.gather(logp, axis, safe.unsqueeze(axis).long())
        loss = torch.where(valid.unsqueeze(axis), -picked,
                           torch.zeros_like(picked))
    return {"Softmax": [softmax], "Loss": [loss]}


@register("cross_entropy", no_grad_slots=("Label",))
def _cross_entropy(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-12
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(x + eps), dim=-1,
                                 keepdim=True)]}
    lbl = label
    if lbl.dim() == x.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    picked = torch.gather(x, -1, lbl.unsqueeze(-1).long())
    return {"Y": [-torch.log(picked + eps)]}


@register("sigmoid_cross_entropy_with_logits", no_grad_slots=("Label",))
def _sce_logits(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    # maximum and the abs of math_ops: their gradients at x == 0 are
    # JAX's (0.5 and 1), which a zero logit meets
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label + \
        torch.log1p(torch.exp(-absolute(x)))
    mask = label != attrs.get("ignore_index", -100)
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp_min(torch.sum(mask.to(x.dtype)), 1.0)
    return {"Out": [loss]}


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

@register("batch_norm", no_grad_slots=("Mean", "Variance"),
          nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                           "SavedVariance", "ReserveSpace"))
def _batch_norm(ctx, ins, attrs):
    """Batch statistics with the biased variance, running statistics
    ``momentum * running + (1 - momentum) * batch`` as new outputs (the
    executor writes them into the scope's tensors)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    use_global = attrs.get("use_global_stats", False) or \
        attrs.get("is_test", False)
    caxis = 1 if attrs.get("data_format", "NCHW") == "NCHW" else x.dim() - 1
    raxes = tuple(i for i in range(x.dim()) if i != caxis)
    bshape = [1] * x.dim()
    bshape[caxis] = x.shape[caxis]
    if use_global:
        m, v = mean, var
        mean_out, var_out, saved_m, saved_v = mean, var, mean, var
    else:
        m = torch.mean(x, dim=raxes)
        v = torch.mean(torch.square(x - m.reshape(bshape)), dim=raxes)
        mean_out = momentum * mean + (1 - momentum) * m
        var_out = momentum * var + (1 - momentum) * v
        saved_m, saved_v = m, torch.rsqrt(v + eps)
    inv = torch.rsqrt(v + eps)
    y = (x - m.reshape(bshape)) * inv.reshape(bshape) * \
        scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [saved_m], "SavedVariance": [saved_v]}


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    stat_shape = tuple(x.shape[:begin])
    if (len(axes) == 1 and ins.get("Scale") and ins.get("Bias")
            and x.shape[-1] % 128 == 0
            and flags.get_flag("use_pallas_layer_norm")):
        y, m, v = fused_layer_norm_with_stats(
            x, ins["Scale"][0], ins["Bias"][0], eps)
        return {"Y": [y], "Mean": [m.reshape(stat_shape)],
                "Variance": [v.reshape(stat_shape)]}
    m = torch.mean(x, dim=axes, keepdim=True)
    v = torch.mean(torch.square(x - m), dim=axes, keepdim=True)
    y = (x - m) * torch.rsqrt(v + eps)
    nshape = tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(nshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(nshape)
    return {"Y": [y], "Mean": [m.reshape(stat_shape)],
            "Variance": [v.reshape(stat_shape)]}


# ---------------------------------------------------------------------------
# Dropout: a custom grad through the saved Mask (a re-run would redraw it)
# ---------------------------------------------------------------------------

@register("dropout", grad_drops_inputs=("X",), grad_needs_outputs=("Mask",),
          nondiff_outputs=("Mask",))
def _dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "upscale_in_train")
    if attrs.get("is_test", False) or p == 0.0:
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out], "Mask": [torch.ones_like(x, dtype=torch.uint8)]}
    keep = prng.uniform(ctx.rng(), tuple(x.shape)) < float(np.float32(1.0 - p))
    zero = torch.zeros_like(x)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), zero)
    else:
        out = torch.where(keep, x, zero)
    return {"Out": [out], "Mask": [keep.to(torch.uint8)]}


@register("dropout_grad")
def _dropout_grad(ctx, ins, attrs):
    g = ins["Out@GRAD"][0]
    keep = ins["Mask"][0] > 0
    p = attrs.get("dropout_prob", 0.5)
    zero = torch.zeros_like(g)
    if attrs.get("dropout_implementation",
                 "upscale_in_train") == "upscale_in_train":
        return {"X@GRAD": [torch.where(keep, g / (1.0 - p), zero)]}
    return {"X@GRAD": [torch.where(keep, g, zero)]}


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

@register("lookup_table_v2", no_grad_slots=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    return {"Out": [F.embedding(ids.long(), w)]}


@register("lookup_table_v2_grad")
def _lookup_table_v2_grad(ctx, ins, attrs):
    """Scatter-add of the rows' gradients (``index_add_``); the
    ``padding_idx`` row gets none."""
    w, ids = ins["W"][0], ins["Ids"][0]
    g = ins["Out@GRAD"][0]
    padding_idx = attrs.get("padding_idx", -1)
    flat_ids = ids.reshape(-1).long()
    flat_g = g.reshape(-1, g.shape[-1]).to(w.dtype)
    if padding_idx is not None and padding_idx >= 0:
        flat_g = torch.where((flat_ids == padding_idx)[:, None],
                             torch.zeros_like(flat_g), flat_g)
    return {"W@GRAD": [torch.zeros_like(w).index_add_(0, flat_ids, flat_g)]}


@register("lookup_table", no_grad_slots=("Ids",))
def _lookup_table(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return {"Out": [F.embedding(ids.long(), w)]}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@register("accuracy", not_differentiable=True)
def _accuracy(ctx, ins, attrs):
    """Inputs Out (top-k values), Indices, Label (metrics/accuracy_op)."""
    indices, label = ins["Indices"][0], ins["Label"][0]
    label_c = label if label.dim() == 2 and label.shape[1] == 1 \
        else label.reshape(-1, 1)
    correct = torch.any(indices == label_c, dim=1)
    num_correct = torch.sum(correct.to(torch.float32))
    n = indices.shape[0]
    return {"Accuracy": [(num_correct / n).reshape(())],
            "Correct": [num_correct.to(torch.int32)],
            "Total": [torch.full((), n, dtype=torch.int32,
                                 device=indices.device)]}

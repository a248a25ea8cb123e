"""Neural-net op lowerings — the counterpart of
``paddle_tpu/ops/nn_ops.py`` for the ops the ported layer builders emit.

Ported: ``conv2d``, ``pool2d``, ``softmax``, ``log_softmax``,
``softmax_with_cross_entropy``, ``cross_entropy``,
``sigmoid_cross_entropy_with_logits``, ``huber_loss``, ``batch_norm``,
``layer_norm``,
``dropout`` (with ``dropout_grad``), ``lookup_table_v2`` (with
``lookup_table_v2_grad``), ``lookup_table`` and ``accuracy``; the dense
rest: ``squared_l2_distance``, ``smooth_l1_loss``, ``mse_loss``,
``kldiv_loss``, ``label_smooth``, ``group_norm``, ``instance_norm``,
``norm``, ``embedding_bag`` and ``auc`` (streaming: its ``StatPos`` /
``StatNeg`` buckets come back as new values, which the executor writes
into the scope's tensors, on the card inside a replay); the image
half: ``depthwise_conv2d``, ``conv2d_transpose``, ``conv3d`` and the
2-d interpolations (``nearest_interp``, ``bilinear_interp``,
``bicubic_interp_v2`` and the v2 forms), which are the reference's
``jax.image.resize`` (:func:`.image_ops.resize`), not ``F.interpolate``.

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
    pw0, pw1]``; a string ("SAME" / "VALID") comes back upper-cased, for
    :func:`_resolve_padding`."""
    if isinstance(paddings, str):
        return paddings.upper()
    p = list(paddings)
    if len(p) == ndim:
        return [(int(x), int(x)) for x in p]
    if len(p) == 2 * ndim:
        return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(ndim)]
    raise ValueError(f"bad paddings {paddings}")


def _resolve_padding(pad, in_sizes, ksizes, strides, dil):
    """XLA's "SAME" / "VALID" padding as [(lo, hi)] per spatial dim (a
    list passes through)."""
    if not isinstance(pad, str):
        return pad
    if pad == "VALID":
        return [(0, 0)] * len(in_sizes)
    out = []
    for n, k, s, d in zip(in_sizes, ksizes, strides, dil):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


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
    pad2 = _resolve_padding(pad2, x.shape[2:], w.shape[2:], strides, dil)
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


@register("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    # channels = groups; the reference shares conv2d's lowering
    return _conv2d(ctx, ins, attrs)


def _transpose_pad(pad, kdims, strides, dil):
    """The padding of a transposed convolution as torch's per-side crop
    of the full output: a list passes through; "SAME" / "VALID" follow
    ``jax.lax.conv_transpose`` (its padding ``p_jax`` of the dilated
    input is ``d * (k - 1) - p``)."""
    if not isinstance(pad, str):
        return pad
    out = []
    for k, s, d in zip(kdims, strides, dil):
        ek = d * (k - 1) + 1
        if pad == "SAME":
            pad_len = ek + s - 2
            pad_a = ek - 1 if s > ek - 1 else int(np.ceil(pad_len / 2))
        else:
            pad_len = ek + s - 2 + max(ek - s, 0)
            pad_a = ek - 1
        out.append((ek - 1 - pad_a, ek - 1 - (pad_len - pad_a)))
    return out


def conv_transpose(x, w, strides, pads, dil, groups):
    """A transposed convolution of ``x [N, C, *S]`` by the reference's
    filter ``[in, out / groups, *k]`` (torch's layout), cropped by
    ``pads`` [(lo, hi)] per spatial dim (zeros added where negative)."""
    nd = x.ndim - 2
    fn = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
          3: F.conv_transpose3d}[nd]
    out = fn(x, w, None, stride=strides, padding=0, dilation=dil,
             groups=groups)
    crop = []
    for lo, hi in reversed(list(pads)):
        crop += [-int(lo), -int(hi)]
    return F.pad(out, crop) if any(crop) else out


@register("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]  # w: [in, out/groups, kh, kw]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1])]
    if int(attrs.get("groups", 1)) != 1:
        raise NotImplementedError("grouped conv2d_transpose")
    pad = _transpose_pad(_conv_padding(attrs.get("paddings", [0, 0]), 2),
                         w.shape[2:], strides, dil)
    return {"Output": [conv_transpose(x, w, strides, pad, dil, 1)]}


@register("conv3d")
def _conv3d(ctx, ins, attrs):
    x, w = ins["Input"][0], ins["Filter"][0]
    strides = [int(s) for s in attrs.get("strides", [1, 1, 1])]
    dil = [int(d) for d in attrs.get("dilations", [1, 1, 1])]
    groups = int(attrs.get("groups", 1))
    pad3 = _resolve_padding(_conv_padding(attrs.get("paddings", [0, 0, 0]),
                                          3),
                            x.shape[2:], w.shape[2:], strides, dil)
    if any(lo != hi for lo, hi in pad3):
        flat = []
        for lo, hi in reversed(pad3):
            flat += [lo, hi]
        x = F.pad(x, flat)
        pad3 = [(0, 0)] * 3
    out = F.conv3d(x, w, None, strides, [lo for lo, _ in pad3], dil, groups)
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
    if isinstance(pad2, str):
        raise NotImplementedError("string padding for pool2d")
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


@register("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    sub = ins["X"][0] - ins["Y"][0]
    return {"sub_result": [sub],
            "Out": [torch.sum(torch.square(sub), dim=-1, keepdim=True)]}


@register("huber_loss", no_grad_slots=("Y",))
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = absolute(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Residual": [r], "Out": [loss]}


@register("smooth_l1_loss", no_grad_slots=("Y",))
def _smooth_l1(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    d = x - y
    ad = absolute(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    loss = torch.sum(loss.reshape(loss.shape[0], -1), dim=1, keepdim=True)
    return {"Diff": [d], "Out": [loss]}


@register("mse_loss", no_grad_slots=("Label",))
def _mse_loss(ctx, ins, attrs):
    return {"Out": [torch.square(ins["Input"][0] - ins["Label"][0])]}


@register("kldiv_loss", no_grad_slots=("Target",))
def _kldiv_loss(ctx, ins, attrs):
    x, tgt = ins["X"][0], ins["Target"][0]
    reduction = attrs.get("reduction", "mean")
    loss = tgt * (torch.log(torch.clamp_min(tgt, 1e-12)) - x)
    loss = torch.where(tgt > 0, loss, torch.zeros_like(loss))
    if reduction == "mean":
        loss = torch.mean(loss)
    elif reduction == "sum":
        loss = torch.sum(loss)
    elif reduction == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


@register("label_smooth", no_grad_slots=("PriorDist",))
def _label_smooth(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if ins.get("PriorDist"):
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


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


def _moments(x, axes):
    """``jnp.mean`` and ``jnp.var`` over ``axes``, kept: the variance is
    the mean of the centred squares, as JAX takes it."""
    m = torch.mean(x, dim=axes, keepdim=True)
    return m, torch.mean(torch.square(x - m), dim=axes, keepdim=True)


def _affine(y, ins, c):
    bshape = (1, c) + (1,) * (y.dim() - 2)
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(bshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(bshape)
    return y


@register("group_norm")
def _group_norm(ctx, ins, attrs):
    x = ins["X"][0]  # NCHW
    groups = attrs.get("groups", 1)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    m, v = _moments(xg, tuple(range(2, xg.dim())))
    y = ((xg - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5))).reshape(
        x.shape)
    return {"Y": [_affine(y, ins, c)], "Mean": [m.reshape(n, groups)],
            "Variance": [v.reshape(n, groups)]}


@register("instance_norm")
def _instance_norm(ctx, ins, attrs):
    x = ins["X"][0]  # NCHW
    m, v = _moments(x, tuple(range(2, x.dim())))
    y = (x - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5))
    n, c = x.shape[0], x.shape[1]
    return {"Y": [_affine(y, ins, c)], "SavedMean": [m.reshape(n, c)],
            "SavedVariance": [v.reshape(n, c)]}


@register("norm")
def _norm(ctx, ins, attrs):
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": [x / norm], "Norm": [norm]}


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


@register("embedding_bag", no_grad_slots=("Ids",))
def _embedding_bag(ctx, ins, attrs):
    emb = F.embedding(ins["Ids"][0].long(), ins["W"][0])
    if attrs.get("mode", "sum") == "sum":
        return {"Out": [torch.sum(emb, dim=1)]}
    return {"Out": [torch.mean(emb, dim=1)]}


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


@register("auc", not_differentiable=True)
def _auc(ctx, ins, attrs):
    """Streaming AUC (metrics/auc_op): each prediction's bucket gains one
    in ``StatPos`` or ``StatNeg``, then the area under the bucketed curve
    by trapezoids, from the highest threshold down."""
    preds = ins["Predict"][0]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    num_thresholds = attrs.get("num_thresholds", 4095)
    pos_prob = preds[:, 1] if preds.dim() == 2 and preds.shape[1] == 2 \
        else preds.reshape(-1)
    bucket = torch.clamp((pos_prob * num_thresholds).to(torch.int32), 0,
                         num_thresholds).to(torch.int64)
    is_pos = (label > 0).to(stat_pos.dtype)
    stat_pos = stat_pos.index_put((bucket,), is_pos, accumulate=True)
    stat_neg = stat_neg.index_put((bucket,), 1 - is_pos, accumulate=True)
    tp = torch.cumsum(torch.flip(stat_pos, (0,)), 0)
    fp = torch.cumsum(torch.flip(stat_neg, (0,)), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp_prev = torch.cat([torch.zeros_like(tp[:1]), tp[:-1]])
    fp_prev = torch.cat([torch.zeros_like(fp[:1]), fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    denom = tot_pos * tot_neg
    auc = torch.where(denom > 0, area / denom, torch.zeros_like(area))
    if auc.dtype != torch.float64:
        auc = auc.to(torch.float32)
    return {"AUC": [auc], "StatPosOut": [stat_pos],
            "StatNegOut": [stat_neg]}


def _interp(name, method):
    @register(name)
    def _lower(ctx, ins, attrs, _method=method):
        """Resize as ``jax.image.resize`` (:func:`.image_ops.resize`)."""
        from .image_ops import resize
        x = ins["X"][0]  # NCHW
        out_h = attrs.get("out_h", -1)
        out_w = attrs.get("out_w", -1)
        scale = attrs.get("scale", 0.0)
        if (out_h is None or out_h <= 0) and scale:
            out_h = int(x.shape[2] * scale)
            out_w = int(x.shape[3] * scale)
        shape = (x.shape[0], x.shape[1], int(out_h), int(out_w))
        return {"Out": [resize(x, shape, _method)]}
    return _lower


_interp("nearest_interp_v2", "nearest")
_interp("bilinear_interp_v2", "linear")
_interp("bicubic_interp_v2", "cubic")
_interp("nearest_interp", "nearest")
_interp("bilinear_interp", "linear")

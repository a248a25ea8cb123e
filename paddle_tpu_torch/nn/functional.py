"""The functional surface of ``paddle_tpu/nn/functional.py``: each
function computes what the reference's op lowering in ``paddle_tpu/ops``
computes (``layer_norm`` at ``ops/nn_ops.py:354``, ``gelu`` at
``ops/math_ops.py:92``, ``softmax_with_cross_entropy`` at
``ops/nn_ops.py:191``, ``conv2d`` at ``ops/nn_ops.py:35``, ``pool2d`` at
``:116``, ``batch_norm`` at ``:314``; the activations at
``ops/math_ops.py:57-155``, the losses at ``ops/nn_ops.py:235-305``,
``pad`` / ``pad2d`` / ``pad3d`` at ``ops/tensor_ops.py:358-390``, the
resizes at ``ops/nn_ops.py:566``), with the reference's defaults and its
edge cases (the gradient of ``leaky_relu`` and ``prelu`` at 0, the
``ignore_index`` of ``binary_cross_entropy_with_logits``, out-of-range
ids of ``one_hot``, ``unfold`` raising as the reference's does).

Each casts its inputs under AMP with the op type the JAX package records
for it (:func:`~paddle_tpu_torch.amp.autocast_inputs`): ``conv2d``
is on the white list, ``batch_norm`` on the black list (f32 under O2),
``pool2d``, ``relu`` and the adds on neither (bf16 under O2). The
convolution is ``torch.nn.functional.conv2d`` (cuDNN on the card) where
the JAX package lowers to ``lax.conv_general_dilated``: neither is a
Pallas kernel.
"""

from __future__ import annotations

import torch

import math

import numpy as np

from .. import flags
from ..amp.auto_cast import autocast_inputs
from ..ops.attention_ops import fused_attention_qkv
from ..ops.cuda.layer_norm import fused_layer_norm
from ..ops.optimizer_ops import _as


def add(x, y):
    """``x + y`` as the reference's ``elementwise_add`` (cast under AMP:
    the residual stream stays bf16 under O2)."""
    x, y = autocast_inputs("elementwise_add", x, y)
    return x + y


def matmul(x, y):
    """``x @ y`` as the reference's ``matmul_v2``."""
    x, y = autocast_inputs("matmul_v2", x, y)
    return x @ y


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the JAX package's ``[in, out]`` weight
    layout: a ``matmul_v2`` then an ``elementwise_add``."""
    y = matmul(x, weight)
    return y if bias is None else add(y, bias)


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the last ``len(normalized_shape)`` axes with the
    biased variance, in the reference's order: ``(x - mean) * rsqrt(var +
    eps) * w + b`` (``paddle_tpu/nn/functional.py:172``); ``weight`` and
    ``bias`` are flat ``[prod(normalized_shape)]`` or None.

    After the AMP cast, the JAX op's predicate (``ops/nn_ops.py:362-365``:
    one normalized axis, weight and bias given, ``h % 128 == 0``,
    ``use_pallas_layer_norm`` on) sends the rows to the fused LayerNorm
    kernels; every other call takes the composed form."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    k = len(normalized_shape)
    x, weight, bias = autocast_inputs("layer_norm", x, weight, bias)
    if k == 1 and weight is not None and bias is not None and \
            x.shape[-1] % 128 == 0 and flags.get_flag("use_pallas_layer_norm"):
        return fused_layer_norm(x, weight, bias, epsilon)
    axes = tuple(range(x.dim() - k, x.dim()))
    m = x.mean(dim=axes, keepdim=True)
    v = (x - m).square().mean(dim=axes, keepdim=True)
    y = (x - m) * torch.rsqrt(v + epsilon)
    nshape = x.shape[x.dim() - k:]
    if weight is not None:
        y = y * weight.reshape(nshape)
    if bias is not None:
        y = y + bias.reshape(nshape)
    return y


def gelu(x, approximate: bool = False):
    """GELU: the exact erf form, or the tanh form on request
    (``jax.nn.gelu``'s two forms, ``paddle_tpu/nn/functional.py:32``)."""
    (x,) = autocast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    (x,) = autocast_inputs("relu", x)
    return torch.relu(x)


def tanh(x):
    (x,) = autocast_inputs("tanh", x)
    return torch.tanh(x)


def softmax(x, axis: int = -1):
    (x,) = autocast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


DROPOUT_MODES = ("upscale_in_train", "downscale_in_infer")


def dropout(x, p: float = 0.5, training: bool = True,
            mode: str = "upscale_in_train"):
    """Dropout as the reference's ``dropout`` op (``ops/nn_ops.py:438``),
    with torch's random bits: ``"upscale_in_train"`` keeps ``x / (1 - p)``
    in training and is the identity otherwise; ``"downscale_in_infer"``
    keeps ``x`` unscaled in training and returns ``x * (1 - p)``
    otherwise. ``p == 0`` draws nothing."""
    if mode not in DROPOUT_MODES:
        raise ValueError(f"dropout mode must be one of {DROPOUT_MODES}, "
                         f"got {mode!r}")
    (x,) = autocast_inputs("dropout", x)
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)
    if mode == "upscale_in_train":
        return torch.nn.functional.dropout(x, p, training=True)
    keep = torch.empty_like(x).bernoulli_(1.0 - p)
    return x * keep


def cross_entropy(input, label, soft_label: bool = False,
                  ignore_index: int = -100, reduction: str = "mean",
                  axis: int = -1):
    """Softmax cross-entropy of logits ``input`` along ``axis``, the
    counterpart of ``paddle_tpu/nn/functional.py:218`` (its
    ``softmax_with_cross_entropy`` at ``ops/nn_ops.py:191``). With hard
    labels (``label`` of ``input``'s shape but 1 along ``axis``, or that
    axis dropped) a label equal to ``ignore_index`` contributes 0, and
    ``"mean"`` divides by the number of labels that are not ignored (at
    least 1), as the reference's ``nll_loss`` total weight does. With
    ``soft_label`` the label is a distribution of ``input``'s shape, each
    row's loss ``-sum(label * log_softmax(input))``, and ``"mean"`` is
    over rows. ``"none"`` returns the per-row losses, 1 along ``axis``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    if soft_label:
        logits, lbl = autocast_inputs("softmax_with_cross_entropy",
                                            input, label)
        logp = torch.log_softmax(logits, dim=axis)
        loss = -(lbl * logp).sum(dim=axis, keepdim=True)
    else:
        (logits,) = autocast_inputs("softmax_with_cross_entropy",
                                          input)
        lbl = label
        if lbl.dim() == logits.dim() and lbl.shape[axis] == 1:
            lbl = lbl.squeeze(axis)
        lbl = lbl.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0).clamp(0, logits.shape[axis] - 1)
        logp = torch.log_softmax(logits, dim=axis)
        picked = logp.gather(axis, safe.unsqueeze(axis))
        loss = torch.where(valid.unsqueeze(axis), -picked, 0.0)
    if reduction == "none":
        return loss
    if soft_label and reduction == "mean":
        (loss,) = autocast_inputs("reduce_mean", loss)
        return loss.mean()
    (loss,) = autocast_inputs("reduce_sum", loss)
    total = loss.sum()
    if soft_label:
        return total
    if reduction == "sum":
        return total
    (count,) = autocast_inputs("reduce_sum", valid.float())
    count, one = autocast_inputs(
        "elementwise_max", count.sum(),
        torch.ones((), dtype=torch.float32, device=count.device))
    denom = torch.maximum(count, one).to(total.dtype)
    total, denom = autocast_inputs("elementwise_div", total, denom)
    return total / denom


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def _padding(padding):
    """The reference's ``_conv_padding`` (``ops/nn_ops.py:24``) as
    ``(torch padding, explicit F.pad amounts or None)``: an int or
    ``[ph, pw]`` is symmetric, ``[ph0, ph1, pw0, pw1]`` is padded
    explicitly, ``"SAME"`` / ``"VALID"`` go to torch by name."""
    if isinstance(padding, str):
        return padding.lower(), None
    p = _pair(padding)
    if len(p) == 2:
        return p, None
    if len(p) == 4:
        return 0, (p[2], p[3], p[0], p[1])
    raise ValueError(f"bad paddings {padding}")


def _nchw(x, data_format):
    if data_format in ("NCHW", "AnyLayout"):
        return x
    if data_format == "NHWC":
        return x.permute(0, 3, 1, 2)
    raise ValueError(f"data_format must be NCHW or NHWC, got {data_format!r}")


def _from_nchw(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups: int = 1, data_format: str = "NCHW"):
    """2-D convolution with an OIHW filter (in either data format, as
    the reference's), then the bias as an ``elementwise_add`` over the
    channel axis."""
    x, weight = autocast_inputs("conv2d", x, weight)
    pad, explicit = _padding(padding)
    xin = _nchw(x, data_format)
    if explicit is not None:
        xin = torch.nn.functional.pad(xin, explicit)
    y = _from_nchw(torch.nn.functional.conv2d(
        xin, weight, None, _pair(stride), pad, _pair(dilation), groups),
        data_format)
    if bias is None:
        return y
    shape = [1, -1, 1, 1] if data_format != "NHWC" else [1, 1, 1, -1]
    y, bias = autocast_inputs("elementwise_add", y, bias)
    return y + bias.reshape(shape)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """Max pooling over NCHW windows, padding with -inf."""
    (x,) = autocast_inputs("pool2d", x)
    pad, explicit = _padding(padding)
    if explicit is not None:
        x = torch.nn.functional.pad(x, explicit, value=float("-inf"))
        pad = 0
    return torch.nn.functional.max_pool2d(
        x, _pair(kernel_size), _pair(stride or kernel_size), pad,
        ceil_mode=ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True):
    """Average pooling over NCHW windows; ``exclusive`` leaves the
    padding out of each window's count."""
    (x,) = autocast_inputs("pool2d", x)
    return torch.nn.functional.avg_pool2d(
        x, _pair(kernel_size), _pair(stride or kernel_size), _pair(padding),
        ceil_mode=ceil_mode, count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size):
    """Average pooling to ``output_size``, which must divide H and W (the
    reference raises otherwise). The 1 x 1 case is the mean over H and W,
    whose backward is deterministic on the card (torch's
    ``adaptive_avg_pool2d`` backward is not)."""
    (x,) = autocast_inputs("pool2d", x)
    oh, ow = _pair(output_size)
    h, w = x.shape[2], x.shape[3]
    if h % oh or w % ow:
        raise NotImplementedError("adaptive pool with non-divisible sizes")
    if (oh, ow) == (1, 1):
        return torch.mean(x, dim=(2, 3), keepdim=True)
    k = [h // oh, w // ow]
    return torch.nn.functional.avg_pool2d(x, k, k)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW"):
    """Batch normalization over every axis but the channel axis (1, or
    the last for ``"NHWC"``), as ``ops/nn_ops.py:317``. In training the
    batch's mean and BIASED variance normalize ``x`` and the running
    statistics become ``momentum * running + (1 - momentum) * batch``,
    written in place into ``running_mean`` / ``running_var`` (torch's
    own update would weight the batch by ``momentum`` and take the
    unbiased variance). In eval the running statistics normalize."""
    x, weight, bias = autocast_inputs("batch_norm", x, weight, bias)
    xin = x.movedim(-1, 1) if data_format == "NHWC" else x
    if not training:
        (rm, rv) = autocast_inputs("batch_norm", running_mean,
                                         running_var)
        y = torch.nn.functional.batch_norm(xin, rm, rv, weight, bias,
                                           training=False, eps=epsilon)
    else:
        y = torch.nn.functional.batch_norm(xin, None, None, weight, bias,
                                           training=True, eps=epsilon)
        with torch.no_grad():
            dims = [d for d in range(xin.dim()) if d != 1]
            var, mean = torch.var_mean(xin, dim=dims, correction=0)
            for buf, batch in ((running_mean, mean), (running_var, var)):
                buf.copy_(buf * _as(momentum, buf)
                          + batch * _as(1 - momentum, batch))
    return y.movedim(1, -1) if data_format == "NHWC" else y


def reshape(x, shape):
    """The reference's ``reshape2``: a 0 in ``shape`` copies that axis of
    ``x``."""
    (x,) = autocast_inputs("reshape2", x)
    return x.reshape([x.shape[i] if d == 0 else d
                      for i, d in enumerate(shape)])


def flatten(x, start_axis=0, stop_axis=-1):
    """The reference's ``flatten_contiguous_range``."""
    (x,) = autocast_inputs("flatten_contiguous_range", x)
    return x.flatten(start_axis, stop_axis)


# -- the rest of the reference's activations ---------------------------------

def _clip(x, lo: float, hi: float):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient at a
    bound is split in half (``torch.clamp``'s is not)."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def relu6(x):
    (x,) = autocast_inputs("relu6", x)
    return _clip(x, 0.0, 6.0)


def sigmoid(x):
    (x,) = autocast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def log_softmax(x, axis: int = -1):
    (x,) = autocast_inputs("log_softmax", x)
    return torch.log_softmax(x, dim=axis)


def leaky_relu(x, negative_slope: float = 0.01):
    """``x`` where ``x >= 0``, else ``negative_slope * x``: the slope of
    1 at 0, as ``jax.nn.leaky_relu``'s."""
    (x,) = autocast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, x * negative_slope)


def elu(x, alpha: float = 1.0):
    """``x`` where ``x > 0``, else ``alpha * expm1(x)``."""
    (x,) = autocast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x)))


def silu(x):
    (x,) = autocast_inputs("silu", x)
    return x * torch.sigmoid(x)


def swish(x):
    """``x * sigmoid(beta x)`` at the op's default ``beta`` 1."""
    (x,) = autocast_inputs("swish", x)
    return x * torch.sigmoid(1.0 * x)


def hardswish(x):
    """``x * clip(x + 3, 0, 6) / 6``."""
    (x,) = autocast_inputs("hard_swish", x)
    return x * _clip(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x):
    """``clip(x / 6 + 0.5, 0, 1)`` (slope 1/6, offset 0.5)."""
    (x,) = autocast_inputs("hard_sigmoid", x)
    return _clip((1.0 / 6) * x + 0.5, 0.0, 1.0)


def softplus(x, beta: float = 1.0, threshold: float = 20.0):
    """``x`` where ``beta x > threshold``, else ``log(1 + exp(beta x)) /
    beta``."""
    (x,) = autocast_inputs("softplus", x)
    z = x * beta
    return torch.where(z > threshold, x,
                       torch.logaddexp(z, torch.zeros_like(z)) / beta)


def prelu(x, weight, data_format="NCHW"):
    """``x`` where ``x >= 0``, else ``alpha * x``: one ``alpha`` for a
    one-element ``weight``, else one per channel (axis 1)."""
    x, weight = autocast_inputs("prelu", x, weight)
    if weight.numel() != 1:
        weight = weight.reshape((1, -1) + (1,) * (x.dim() - 2))
    return torch.where(x >= 0, x, weight * x)


# -- convolution, lookup and normalization -----------------------------------

def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     dilation=1, groups: int = 1):
    """Transposed 2-D convolution with the reference's filter layout
    ``[in, out / groups, kh, kw]`` (torch's own), padding ``p`` per side
    (``[ph, pw]`` or ``[ph0, ph1, pw0, pw1]``), no output padding; then
    the bias over the channel axis. Grouped filters raise, as in the
    reference."""
    if groups != 1:
        raise NotImplementedError("grouped conv2d_transpose")
    x, weight = autocast_inputs("conv2d_transpose", x, weight)
    p = _pair(padding)
    if len(p) == 2:
        p = [p[0], p[0], p[1], p[1]]
    elif len(p) != 4:
        raise ValueError(f"bad paddings {padding}")
    y = torch.nn.functional.conv_transpose2d(
        x, weight, None, _pair(stride), 0, 0, 1, _pair(dilation))
    h, w = y.shape[2], y.shape[3]
    y = y[:, :, p[0]:h - p[1], p[2]:w - p[3]]
    if bias is None:
        return y
    y, bias = autocast_inputs("elementwise_add", y, bias)
    return y + bias.reshape(1, -1, 1, 1)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` for the ids ``x``; the ``padding_idx`` row
    (negative counts from the end) receives no gradient."""
    (weight,) = autocast_inputs("lookup_table_v2", weight)
    rows = weight[x.long()]
    if padding_idx is None:
        return rows
    if padding_idx < 0:
        padding_idx += weight.shape[0]
    return torch.where((x == padding_idx)[..., None], rows.detach(), rows)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5):
    """Normalization over each group of ``C / num_groups`` channels and
    the spatial axes (biased variance), then the per-channel affine."""
    x, weight, bias = autocast_inputs("group_norm", x, weight, bias)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    m = xg.mean(dim=axes, keepdim=True)
    v = (xg - m).square().mean(dim=axes, keepdim=True)
    y = ((xg - m) * torch.rsqrt(v + epsilon)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if weight is not None:
        y = y * weight.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


# -- losses ------------------------------------------------------------------

def _reduce(out, reduction):
    if reduction == "mean":
        (out,) = autocast_inputs("reduce_mean", out)
        return out.mean()
    if reduction == "sum":
        (out,) = autocast_inputs("reduce_sum", out)
        return out.sum()
    return out


def mse_loss(input, label, reduction: str = "mean"):
    input, label = autocast_inputs("mse_loss", input, label)
    return _reduce((input - label).square(), reduction)


def l1_loss(input, label, reduction: str = "mean"):
    input, label = autocast_inputs("elementwise_sub", input, label)
    (d,) = autocast_inputs("abs", input - label)
    return _reduce(d.abs(), reduction)


def binary_cross_entropy_with_logits(logit, label, reduction: str = "mean"):
    """``max(x, 0) - x * label + log1p(exp(-|x|))``, 0 where the label is
    -100 (the op's ``ignore_index``)."""
    x, label = autocast_inputs("sigmoid_cross_entropy_with_logits", logit,
                               label)
    loss = torch.clamp(x, min=0) - x * label + torch.log1p(
        torch.exp(-x.abs()))
    return _reduce(torch.where(label != -100, loss, 0.0), reduction)


def nll_loss(input, label, reduction: str = "mean"):
    """``-input[i, label[i]]`` over log-probabilities ``input [n, C]``."""
    (input,) = autocast_inputs("gather_nd", input)
    n = input.shape[0]
    lbl = label.reshape(n).long()
    picked = input[torch.arange(n, device=input.device), lbl]
    return _reduce(-picked, reduction)


def kl_div(input, label, reduction: str = "mean"):
    """``label * (log(label) - input)`` where ``label > 0``, else 0;
    ``"batchmean"`` sums and divides by the batch."""
    x, tgt = autocast_inputs("kldiv_loss", input, label)
    loss = tgt * (torch.log(torch.clamp(tgt, min=1e-12)) - x)
    loss = torch.where(tgt > 0, loss, 0.0)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return loss


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    """The reference's ``huber_loss`` of ``r = label - input``: ``0.5 r²``
    where ``|r| <= delta``, else ``delta (|r| - 0.5 delta)``."""
    x, y = autocast_inputs("huber_loss", input, label)
    r = y - x
    ar = r.abs()
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return _reduce(loss, reduction)


def label_smooth(label, prior_dist=None, epsilon: float = 0.1):
    """``(1 - eps) label + eps / K`` over the last axis's K classes, or
    ``+ eps * prior_dist``."""
    label, prior_dist = autocast_inputs("label_smooth", label, prior_dist)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def one_hot(x, num_classes):
    """float32 one-hot rows over a new last axis; an id outside
    ``[0, num_classes)`` gives a zero row (``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


# -- attention ---------------------------------------------------------------

def scaled_dot_product_attention(q, k, v, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True):
    """Attention over ``[batch, heads, seq, head_dim]`` q/k/v by the
    reference's routes: with ``dropout_p > 0`` in training, the composed
    ``softmax(q k^T / sqrt(d) + masks)`` with dropout on the
    probabilities, then ``@ v``; otherwise the ``fused_attention_qkv`` op
    (:func:`~paddle_tpu_torch.ops.attention_ops.fused_attention_qkv`:
    the flash kernels where its predicate admits the call)."""
    if dropout_p > 0.0 and training:
        scale = 1.0 / math.sqrt(q.shape[-1])
        logits = matmul(q, k.transpose(-1, -2)) * scale
        if is_causal:
            s_q, s_k = logits.shape[-2], logits.shape[-1]
            cm = np.triu(np.full((s_q, s_k), np.finfo(np.float32).min,
                                 np.float32), 1)
            logits = add(logits, torch.from_numpy(cm).to(logits.device))
        if attn_mask is not None:
            logits = add(logits, attn_mask)
        probs = dropout(softmax(logits, axis=-1), dropout_p, training=True)
        return matmul(probs, v)
    return fused_attention_qkv(q, k, v, mask=attn_mask, causal=is_causal)


# -- padding, unfold and resizing --------------------------------------------

_PAD2D_MODES = {"reflect": "reflect", "edge": "replicate",
                "circular": "circular"}
_PAD3D_MODES = {"reflect": "reflect", "replicate": "replicate",
                "circular": "circular"}


def pad(x, pad, mode="constant", value=0.0, data_format="NCDHW"):
    """The reference's three routes: four amounts on a 4-D ``x`` pad W
    by ``pad[0:2]`` and H by ``pad[2:4]`` (``pad2d``; modes constant,
    reflect, edge, circular); six on a 5-D ``x`` pad W, H, D (``pad3d``;
    constant, reflect, replicate, circular); any other form pads the
    last axes first, with ``value``, whatever ``mode`` says (``pad``)."""
    tn = torch.nn.functional
    if len(pad) == 4 and x.dim() == 4:
        (x,) = autocast_inputs("pad2d", x)
        amounts = (pad[0], pad[1], pad[2], pad[3])
        if mode == "constant":
            return tn.pad(x, amounts, value=value)
        return tn.pad(x, amounts, mode=_PAD2D_MODES[mode])
    if len(pad) == 6 and x.dim() == 5:
        (x,) = autocast_inputs("pad3d", x)
        if mode == "constant":
            return tn.pad(x, tuple(pad), value=value)
        return tn.pad(x, tuple(pad), mode=_PAD3D_MODES[mode])
    (x,) = autocast_inputs("pad", x)
    return tn.pad(x, tuple(pad), value=value)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """Not implemented, as in the reference (which raises this error)."""
    raise NotImplementedError("unfold: planned with pallas im2col")


_RESIZE_OPS = {"nearest": "nearest_interp_v2",
               "bilinear": "bilinear_interp_v2",
               "bicubic": "bicubic_interp_v2"}


def _keys_cubic(z):
    out = ((1.5 * z - 2.5) * z) * z + 1.0
    out = np.where(z >= 1.0, ((-0.5 * z + 2.5) * z - 4.0) * z + 2.0, out)
    return np.where(z >= 2.0, 0.0, out)


def _triangle(z):
    return np.maximum(0.0, 1.0 - np.abs(z))


def _resize_weights(m: int, n: int, kernel) -> np.ndarray:
    """``jax.image.resize``'s ``[m, n]`` weights of one axis (half-pixel
    centres, the kernel widened when downsampling, columns normalized,
    samples outside the input zeroed), in float64."""
    inv = m / n
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(n) + 0.5) * inv - 0.5
    z = np.abs(sample[None, :] - np.arange(m)[:, None]) / kernel_scale
    w = kernel(z)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interpolate(x, size=None, scale_factor=None, mode="nearest"):
    """Resize NCHW ``x`` to ``size`` (or by ``scale_factor``) as the
    reference's ``*_interp_v2`` ops do through ``jax.image.resize``:
    ``"nearest"`` picks input ``floor((i + 0.5) m / n)``; ``"bilinear"``
    and ``"bicubic"`` (Keys' cubic, a = -0.5) weigh half-pixel-centred
    samples, with the kernel widened to low-pass when downsampling."""
    op = _RESIZE_OPS[mode]
    (x,) = autocast_inputs(op, x)
    h, w = x.shape[2], x.shape[3]
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor, scale_factor]
        size = [int(h * sf[0]), int(w * sf[1])]
    out = [int(size[0]), int(size[1])]
    if mode == "nearest":
        for axis, (m, n) in ((2, (h, out[0])), (3, (w, out[1]))):
            if m != n:
                idx = np.floor(((np.arange(n, dtype=np.float32) + 0.5) *
                                np.float32(m) / np.float32(n))
                               .astype(np.float32)).astype(np.int64)
                x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
        return x
    kernel = _triangle if mode == "bilinear" else _keys_cubic
    if not x.is_floating_point():
        x = x.float()
    for axis, (m, n) in ((2, (h, out[0])), (3, (w, out[1]))):
        if m != n:
            wm = torch.from_numpy(_resize_weights(m, n, kernel)).to(
                x.device, x.dtype)
            x = torch.movedim(torch.movedim(x, axis, -1) @ wm, -1, axis)
    return x

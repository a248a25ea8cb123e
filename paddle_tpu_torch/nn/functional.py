"""Functional forms of the layers and the loss the GPT, ERNIE and ResNet
slices use — the counterparts of the matching lowerings in
``paddle_tpu/ops`` (``layer_norm`` at ``ops/nn_ops.py:354``, ``gelu`` at
``ops/math_ops.py:92``, ``softmax_with_cross_entropy`` at
``ops/nn_ops.py:191``, ``conv2d`` at ``ops/nn_ops.py:35``, ``pool2d`` at
``:116``, ``batch_norm`` at ``:314``) and of
``paddle_tpu/nn/functional.py``.

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

from .. import flags
from ..amp.auto_cast import autocast_inputs
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

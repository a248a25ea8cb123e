"""Functional forms of the layers and the loss the GPT, ERNIE and ResNet
slices use — the counterparts of the matching lowerings in
``paddle_tpu/ops`` (``layer_norm`` at ``ops/nn_ops.py:354``, ``gelu`` at
``ops/math_ops.py:92``, ``softmax_with_cross_entropy`` at
``ops/nn_ops.py:191``, ``conv2d`` at ``ops/nn_ops.py:35``, ``pool2d`` at
``:116``, ``batch_norm`` at ``:314``) and of
``paddle_tpu/nn/functional.py``.

Each casts its inputs under AMP with the op type the JAX package records
for it (:func:`~paddle_tpu_torch.amp.maybe_autocast_inputs`): ``conv2d``
is on the white list, ``batch_norm`` on the black list (f32 under O2),
``pool2d``, ``relu`` and the adds on neither (bf16 under O2). The
convolution is ``torch.nn.functional.conv2d`` (cuDNN on the card) where
the JAX package lowers to ``lax.conv_general_dilated``: neither is a
Pallas kernel.
"""

from __future__ import annotations

import torch

from .. import flags
from ..amp.auto_cast import maybe_autocast_inputs
from ..ops.cuda.layer_norm import fused_layer_norm
from ..ops.optimizer_ops import _as


def add(x, y):
    """``x + y`` as the reference's ``elementwise_add`` (cast under AMP:
    the residual stream stays bf16 under O2)."""
    x, y = maybe_autocast_inputs("elementwise_add", x, y)
    return x + y


def matmul(x, y):
    """``x @ y`` as the reference's ``matmul_v2``."""
    x, y = maybe_autocast_inputs("matmul_v2", x, y)
    return x @ y


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the JAX package's ``[in, out]`` weight
    layout: a ``matmul_v2`` then an ``elementwise_add``."""
    y = matmul(x, weight)
    return y if bias is None else add(y, bias)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with the biased variance, in the
    reference's order: ``(x - mean) * rsqrt(var + eps) * w + b``.

    After the AMP cast, the JAX op's predicate (``ops/nn_ops.py:362-365``:
    weight and bias given, which every port caller does; ``h % 128 ==
    0``; ``use_pallas_layer_norm`` on) sends the rows to the fused
    LayerNorm kernels; every other call takes the composed form."""
    x, weight, bias = maybe_autocast_inputs("layer_norm", x, weight, bias)
    if x.shape[-1] % 128 == 0 and flags.get_flag("use_pallas_layer_norm"):
        return fused_layer_norm(x, weight, bias, eps)
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * weight + bias


def gelu(x, approximate: bool = False):
    """GELU: the exact erf form, or the tanh form on request
    (``jax.nn.gelu``'s two forms, ``paddle_tpu/nn/functional.py:32``)."""
    (x,) = maybe_autocast_inputs("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x):
    (x,) = maybe_autocast_inputs("relu", x)
    return torch.relu(x)


def tanh(x):
    (x,) = maybe_autocast_inputs("tanh", x)
    return torch.tanh(x)


def softmax(x, axis: int = -1):
    (x,) = maybe_autocast_inputs("softmax", x)
    return torch.softmax(x, dim=axis)


def dropout(x, p: float, training: bool = True):
    """Upscale-in-train dropout (torch's bits, not the reference's);
    identity when not training or at ``p == 0``."""
    (x,) = maybe_autocast_inputs("dropout", x)
    if not training or p == 0.0:
        return x
    return torch.nn.functional.dropout(x, p, training=True)


def cross_entropy(input, label, ignore_index: int = -100,
                  reduction: str = "mean"):
    """Softmax cross-entropy of logits ``input [N, C]`` against hard
    labels ``label`` (``[N]`` or ``[N, 1]``), the counterpart of
    ``paddle_tpu/nn/functional.py:218``. Labels equal to
    ``ignore_index`` contribute 0, and ``"mean"`` divides by the number
    of labels that are not ignored (at least 1), as the reference's
    ``nll_loss`` total weight does. ``"none"`` returns the ``[N, 1]``
    per-row losses."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    (logits,) = maybe_autocast_inputs("softmax_with_cross_entropy", input)
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0).clamp(0, logits.shape[-1] - 1)
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, safe[..., None])
    loss = torch.where(valid[..., None], -picked, 0.0)
    if reduction == "none":
        return loss
    (loss,) = maybe_autocast_inputs("reduce_sum", loss)
    total = loss.sum()
    if reduction == "sum":
        return total
    (count,) = maybe_autocast_inputs("reduce_sum", valid.float())
    count, one = maybe_autocast_inputs(
        "elementwise_max", count.sum(),
        torch.ones((), dtype=torch.float32, device=count.device))
    denom = torch.maximum(count, one).to(total.dtype)
    total, denom = maybe_autocast_inputs("elementwise_div", total, denom)
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
    x, weight = maybe_autocast_inputs("conv2d", x, weight)
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
    y, bias = maybe_autocast_inputs("elementwise_add", y, bias)
    return y + bias.reshape(shape)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    """Max pooling over NCHW windows, padding with -inf."""
    (x,) = maybe_autocast_inputs("pool2d", x)
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
    (x,) = maybe_autocast_inputs("pool2d", x)
    return torch.nn.functional.avg_pool2d(
        x, _pair(kernel_size), _pair(stride or kernel_size), _pair(padding),
        ceil_mode=ceil_mode, count_include_pad=not exclusive)


def adaptive_avg_pool2d(x, output_size):
    """Average pooling to ``output_size``, which must divide H and W (the
    reference raises otherwise). The 1 x 1 case is the mean over H and W,
    whose backward is deterministic on the card (torch's
    ``adaptive_avg_pool2d`` backward is not)."""
    (x,) = maybe_autocast_inputs("pool2d", x)
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
    x, weight, bias = maybe_autocast_inputs("batch_norm", x, weight, bias)
    xin = x.movedim(-1, 1) if data_format == "NHWC" else x
    if not training:
        (rm, rv) = maybe_autocast_inputs("batch_norm", running_mean,
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
    (x,) = maybe_autocast_inputs("reshape2", x)
    return x.reshape([x.shape[i] if d == 0 else d
                      for i, d in enumerate(shape)])


def flatten(x, start_axis=0, stop_axis=-1):
    """The reference's ``flatten_contiguous_range``."""
    (x,) = maybe_autocast_inputs("flatten_contiguous_range", x)
    return x.flatten(start_axis, stop_axis)

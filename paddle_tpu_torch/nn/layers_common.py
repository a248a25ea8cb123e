"""The layer classes of ``paddle_tpu/nn/layers_common.py``: ``Linear``,
``LayerNorm``, ``GroupNorm``, ``Embedding``, ``Dropout``, ``Conv2D``,
``Conv2DTranspose``, ``BatchNorm2D`` (and its aliases), ``SyncBatchNorm``
(local batch statistics, the reference's form outside a mesh; the
cross-replica form waits for the sharding item of ROADMAP.md), the pools,
the activations, ``Flatten``, ``Pad2D``, ``Upsample`` and the losses,
each over its :mod:`.functional` counterpart.

Parameters are made on an explicit ``device`` from an explicit
``torch.Generator`` (which must live on that device), with the JAX
package's distributions: by default Xavier-uniform Linear weights and
N(0, 1) embeddings, or N(0, std²) where a model passes ``std``.
``Linear`` keeps the JAX ``[in, out]`` weight layout, so weights copy
across by name without a transpose and the tied LM head is the same
``h @ wte.T``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..amp.auto_cast import autocast_inputs
from . import functional as F


def _normal(shape, std, device, generator):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(w.normal_(0.0, std, generator=generator))


def _wants(name: str, attr, bias: bool = False) -> bool:
    """Whether a ``weight_attr`` / ``bias_attr`` asks for its parameter:
    None and True do, False drops a bias (the reference's
    ``ParamAttr._to_attr``). A ``ParamAttr``, name or initializer (and a
    dropped weight) raise: the port draws parameters from its own
    generator; the static builders take a ``ParamAttr``
    (:mod:`paddle_tpu_torch.param_attr`), the eager layers wait for ROADMAP
    A7.5 (the dygraph plane) to honour one."""
    if attr is None or attr is True:
        return True
    if attr is False and bias:
        return False
    raise NotImplementedError(
        f"{name}={attr!r} is not ported: parameter attributes wait for "
        "ROADMAP A7.5 (ParamAttr in the eager layers, with the dygraph "
        "plane)")


class Linear(nn.Module):
    """``y = x @ W + b``; W ``[in, out]`` drawn from N(0, std²) when
    ``std`` is given, else Xavier-uniform, U(-l, l) with ``l = sqrt(6 /
    (in + out))`` (``paddle_tpu/initializer.py:77-94``); b zero."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 std: float = None, device, generator: torch.Generator):
        super().__init__()
        _wants("weight_attr", weight_attr)
        if std is None:
            limit = math.sqrt(6.0 / (in_features + out_features))
            w = torch.empty((in_features, out_features), device=device)
            self.weight = nn.Parameter(
                w.uniform_(-limit, limit, generator=generator))
        else:
            self.weight = _normal((in_features, out_features), std, device,
                                  generator)
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=device)) if _wants(
                "bias_attr", bias_attr, bias=True) else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last ``len(normalized_shape)`` axes (biased
    variance); weight one, bias zero (none with ``bias_attr=False``)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, *, device):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        n = math.prod(self._normalized_shape)
        _wants("weight_attr", weight_attr)
        self.weight = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device)) if _wants(
            "bias_attr", bias_attr, bias=True) else None

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Embedding(nn.Module):
    """Lookup table ``[num, dim]`` drawn from N(0, std²), N(0, 1) by
    default. Under AMP O2 the table is cast before the lookup, as the
    reference's ``lookup_table_v2`` is, so rows come out in bf16 and the
    gradient of repeated ids accumulates in bf16 before it returns to
    the f32 table. ``padding_idx`` (negative counts from the end) starts
    as a zero row and receives no gradient, as in the reference.
    ``sparse`` is accepted and has no effect, as in the reference."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: int = None, sparse: bool = False,
                 weight_attr=None, *, std: float = 1.0, device,
                 generator: torch.Generator):
        super().__init__()
        _wants("weight_attr", weight_attr)
        self.weight = _normal((num_embeddings, embedding_dim), std, device,
                              generator)
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        (weight,) = autocast_inputs("lookup_table_v2", self.weight)
        rows = weight[x]
        if self.padding_idx is None:
            return rows
        pad = (x == self.padding_idx)[..., None]
        return torch.where(pad, rows.detach(), rows)


class Dropout(nn.Module):
    """:func:`~.functional.dropout` in ``mode``; at ``p == 0`` (every
    serving path) or in eval mode under ``"upscale_in_train"``, the
    identity."""

    def __init__(self, p=0.5, mode="upscale_in_train"):
        super().__init__()
        if mode not in F.DROPOUT_MODES:
            raise ValueError(f"dropout mode must be one of "
                             f"{F.DROPOUT_MODES}, got {mode!r}")
        self.p = float(p)
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Conv2D(nn.Module):
    """2-D convolution with an OIHW weight ``[out, in / groups, kh, kw]``
    drawn Xavier-uniform (fan_in ``in / groups * kh * kw``, fan_out ``out
    * kh * kw``, ``paddle_tpu/initializer.py:21-31``) and a zero bias,
    none with ``bias_attr=False``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW", *, device,
                 generator: torch.Generator):
        super().__init__()
        _wants("weight_attr", weight_attr)
        k = [kernel_size] * 2 if isinstance(kernel_size, int) \
            else list(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        shape = [out_channels, in_channels // groups] + k
        receptive = k[0] * k[1]
        limit = math.sqrt(6.0 / (shape[1] * receptive
                                 + out_channels * receptive))
        w = torch.empty(shape, device=device)
        self.weight = nn.Parameter(w.uniform_(-limit, limit,
                                              generator=generator))
        self.bias = nn.Parameter(torch.zeros(
            out_channels, device=device)) if _wants(
                "bias_attr", bias_attr, bias=True) else None

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)


class BatchNorm2D(nn.Module):
    """Batch normalization with the reference's running statistics
    (``momentum`` 0.9 weighting the running value, biased batch
    variance; :func:`~.functional.batch_norm`): weight one, bias zero,
    buffers ``_mean`` (zeros) and ``_variance`` (ones), the reference's
    names, updated in place in training."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device):
        super().__init__()
        _wants("weight_attr", weight_attr)
        _wants("bias_attr", bias_attr)
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format)


BatchNorm = BatchNorm2D
BatchNorm1D = BatchNorm2D
BatchNorm3D = BatchNorm2D


class SyncBatchNorm(BatchNorm2D):
    """The reference's ``sync_batch_norm`` op outside a mesh
    (``paddle_tpu/ops/collective_ops.py:194``): the batch's statistics
    from sums, ``mean = sum(x) / n`` and ``var = sum(x²) / n - mean²``,
    normalize ``x`` in training and update the running statistics in
    place (``momentum`` weighting the running value); eval uses the
    running statistics. The cross-replica sum waits for the sharding
    item of ROADMAP.md."""

    def forward(self, x):
        (x,) = autocast_inputs("sync_batch_norm", x)
        caxis = 1 if self._data_format == "NCHW" else x.dim() - 1
        raxes = tuple(i for i in range(x.dim()) if i != caxis)
        bshape = [1] * x.dim()
        bshape[caxis] = x.shape[caxis]
        if not self.training:
            m, v = self._mean, self._variance
        else:
            cnt = float(math.prod(x.shape[i] for i in raxes))
            m = x.sum(dim=raxes) / cnt
            v = x.square().sum(dim=raxes) / cnt - m * m
            with torch.no_grad():
                mo = self._momentum
                self._mean.copy_(mo * self._mean + (1 - mo) * m)
                self._variance.copy_(mo * self._variance + (1 - mo) * v)
        inv = torch.rsqrt(v + self._epsilon)
        return (x - m.reshape(bshape)) * inv.reshape(bshape) * \
            self.weight.reshape(bshape) + self.bias.reshape(bshape)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Replace every ``BatchNorm2D`` below ``layer`` (or ``layer``
        itself) by a ``SyncBatchNorm`` sharing its parameters and
        buffers."""
        if isinstance(layer, BatchNorm2D) and not isinstance(layer, cls):
            new = cls(layer.weight.shape[0], layer._momentum,
                      layer._epsilon, data_format=layer._data_format,
                      device=layer.weight.device)
            new.weight = layer.weight
            new.bias = layer.bias
            new._mean = layer._mean
            new._variance = layer._variance
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class Conv2DTranspose(nn.Module):
    """Transposed 2-D convolution with a ``[in, out / groups, kh, kw]``
    weight drawn Xavier-uniform (the reference's fans of that shape:
    fan_in ``out / groups * kh * kw``, fan_out ``in * kh * kw``) and a zero
    bias, none with ``bias_attr=False``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, *, device, generator: torch.Generator):
        super().__init__()
        _wants("weight_attr", weight_attr)
        k = [kernel_size] * 2 if isinstance(kernel_size, int) \
            else list(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        shape = [in_channels, out_channels // groups] + k
        receptive = k[0] * k[1]
        limit = math.sqrt(6.0 / (shape[1] * receptive
                                 + in_channels * receptive))
        w = torch.empty(shape, device=device)
        self.weight = nn.Parameter(w.uniform_(-limit, limit,
                                              generator=generator))
        self.bias = nn.Parameter(torch.zeros(
            out_channels, device=device)) if _wants(
                "bias_attr", bias_attr, bias=True) else None

    def forward(self, x):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._dilation,
                                  self._groups)


class GroupNorm(nn.Module):
    """:func:`~.functional.group_norm` with a per-channel weight (one)
    and bias (zero, none with ``bias_attr=False``)."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, *, device):
        super().__init__()
        _wants("weight_attr", weight_attr)
        self._num_groups = num_groups
        self._epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(
            num_channels, device=device)) if _wants(
                "bias_attr", bias_attr, bias=True) else None

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias,
                            self._epsilon)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode)

    def forward(self, x):
        return F.max_pool2d(x, *self._args)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True):
        super().__init__()
        self._args = (kernel_size, stride, padding, ceil_mode, exclusive)

    def forward(self, x):
        return F.avg_pool2d(x, *self._args)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size)


def _act_layer(name, fn):
    """An activation layer: its constructor's arguments are ``fn``'s
    after ``x``, as the reference's ``_act_layer``."""
    class _Act(nn.Module):
        def __init__(self, *a, **kw):
            super().__init__()
            self._a, self._kw = a, kw

        def forward(self, x):
            return fn(x, *self._a, **self._kw)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _act_layer("ReLU", F.relu)
ReLU6 = _act_layer("ReLU6", F.relu6)
GELU = _act_layer("GELU", F.gelu)
Sigmoid = _act_layer("Sigmoid", F.sigmoid)
Tanh = _act_layer("Tanh", F.tanh)
Softmax = _act_layer("Softmax", F.softmax)
LogSoftmax = _act_layer("LogSoftmax", F.log_softmax)
LeakyReLU = _act_layer("LeakyReLU", F.leaky_relu)
SiLU = _act_layer("SiLU", F.silu)
Swish = _act_layer("Swish", F.swish)
Hardswish = _act_layer("Hardswish", F.hardswish)
Hardsigmoid = _act_layer("Hardsigmoid", F.hardsigmoid)
ELU = _act_layer("ELU", F.elu)
Softplus = _act_layer("Softplus", F.softplus)


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self._axes = (start_axis, stop_axis)

    def forward(self, x):
        return F.flatten(x, *self._axes)


class CrossEntropyLoss(nn.Module):
    """:func:`~.functional.cross_entropy` with the layer's arguments."""

    def __init__(self, soft_label=False, ignore_index=-100,
                 reduction="mean", axis=-1):
        super().__init__()
        self._args = (soft_label, ignore_index, reduction, axis)

    def forward(self, input, label):
        return F.cross_entropy(input, label, *self._args)


class _Loss(nn.Module):
    """A loss layer: ``fn(input, label, *args)``."""

    fn = None

    def forward(self, input, label):
        return type(self).fn(input, label, *self._args)


class MSELoss(_Loss):
    fn = staticmethod(F.mse_loss)

    def __init__(self, reduction="mean"):
        super().__init__()
        self._args = (reduction,)


class L1Loss(_Loss):
    fn = staticmethod(F.l1_loss)

    def __init__(self, reduction="mean"):
        super().__init__()
        self._args = (reduction,)


class BCEWithLogitsLoss(_Loss):
    fn = staticmethod(F.binary_cross_entropy_with_logits)

    def __init__(self, reduction="mean"):
        super().__init__()
        self._args = (reduction,)


class NLLLoss(_Loss):
    fn = staticmethod(F.nll_loss)

    def __init__(self, reduction="mean"):
        super().__init__()
        self._args = (reduction,)


class KLDivLoss(_Loss):
    fn = staticmethod(F.kl_div)

    def __init__(self, reduction="mean"):
        super().__init__()
        self._args = (reduction,)


class SmoothL1Loss(_Loss):
    fn = staticmethod(F.smooth_l1_loss)

    def __init__(self, reduction="mean", delta=1.0):
        super().__init__()
        self._args = (reduction, delta)


class Pad2D(nn.Module):
    """:func:`~.functional.pad` with four amounts (an int pads all four
    sides)."""

    def __init__(self, padding, mode="constant", value=0.0):
        super().__init__()
        self._padding = padding if isinstance(padding, (list, tuple)) \
            else [padding] * 4
        self._mode, self._value = mode, value

    def forward(self, x):
        return F.pad(x, self._padding, self._mode, self._value)


class Upsample(nn.Module):
    """:func:`~.functional.interpolate` with the layer's arguments."""

    def __init__(self, size=None, scale_factor=None, mode="nearest"):
        super().__init__()
        self._args = (size, scale_factor, mode)

    def forward(self, x):
        return F.interpolate(x, *self._args)

"""The layer classes the GPT, ERNIE and ResNet slices use — counterparts
of ``Linear``, ``LayerNorm``, ``Embedding``, ``Dropout``, ``Conv2D``,
``BatchNorm2D``, the pools, ``ReLU``, ``Flatten`` and
``CrossEntropyLoss`` in ``paddle_tpu/nn/layers_common.py``.

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
    generator and has no ``ParamAttr`` (ROADMAP A7)."""
    if attr is None or attr is True:
        return True
    if attr is False and bias:
        return False
    raise NotImplementedError(
        f"{name}={attr!r} is not ported: parameter attributes wait for "
        "ROADMAP A7 (the static-graph plane)")


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


class ReLU(nn.Module):
    def forward(self, x):
        return F.relu(x)


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

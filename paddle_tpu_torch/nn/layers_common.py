"""The layer classes the GPT and ERNIE slices use — counterparts of
``Linear``, ``LayerNorm``, ``Embedding`` and ``Dropout`` in
``paddle_tpu/nn/layers_common.py``.

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

from ..amp.auto_cast import maybe_autocast_inputs
from . import functional as F


def _normal(shape, std, device, generator):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.Parameter(w.normal_(0.0, std, generator=generator))


class Linear(nn.Module):
    """``y = x @ W + b``; W ``[in, out]`` drawn from N(0, std²) when
    ``std`` is given, else Xavier-uniform, U(-l, l) with ``l = sqrt(6 /
    (in + out))`` (``paddle_tpu/initializer.py:77-94``); b zero."""

    def __init__(self, in_features: int, out_features: int, *,
                 std: float = None, device, generator: torch.Generator):
        super().__init__()
        if std is None:
            limit = math.sqrt(6.0 / (in_features + out_features))
            w = torch.empty((in_features, out_features), device=device)
            self.weight = nn.Parameter(
                w.uniform_(-limit, limit, generator=generator))
        else:
            self.weight = _normal((in_features, out_features), std, device,
                                  generator)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis (biased variance); weight one, bias
    zero."""

    def __init__(self, n: int, eps: float = 1e-5, *, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.eps)


class Embedding(nn.Module):
    """Lookup table ``[num, dim]`` drawn from N(0, std²), N(0, 1) by
    default. Under AMP O2 the table is cast before the lookup, as the
    reference's ``lookup_table_v2`` is, so rows come out in bf16 and the
    gradient of repeated ids accumulates in bf16 before it returns to
    the f32 table. ``padding_idx`` (negative counts from the end) starts
    as a zero row and receives no gradient, as in the reference."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx: int = None, *, std: float = 1.0, device,
                 generator: torch.Generator):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, device,
                              generator)
        if padding_idx is not None and padding_idx < 0:
            padding_idx += num_embeddings
        self.padding_idx = padding_idx
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, ids):
        (weight,) = maybe_autocast_inputs("lookup_table_v2", self.weight)
        rows = weight[ids]
        if self.padding_idx is None:
            return rows
        pad = (ids == self.padding_idx)[..., None]
        return torch.where(pad, rows.detach(), rows)


class Dropout(nn.Module):
    """Identity in eval mode or at p = 0 (every serving path)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        return torch.nn.functional.dropout(x, self.p, training=True)

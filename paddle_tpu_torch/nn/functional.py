"""Functional forms of the layers the GPT slice uses — the counterparts
of the matching lowerings in ``paddle_tpu/ops`` (``layer_norm`` at
``ops/nn_ops.py:354``, ``gelu`` at ``ops/math_ops.py:92``)."""

from __future__ import annotations

import torch


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the JAX package's ``[in, out]``
    weight layout."""
    y = x @ weight
    return y if bias is None else y + bias


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with the biased variance, in the
    reference's order: ``(x - mean) * rsqrt(var + eps) * w + b``."""
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * weight + bias


def gelu(x):
    """GELU in the tanh form GPT-2 uses (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")

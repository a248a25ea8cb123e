"""Functional forms of the layers and the loss the GPT and ERNIE slices
use — the counterparts of the matching lowerings in ``paddle_tpu/ops``
(``layer_norm`` at ``ops/nn_ops.py:354``, ``gelu`` at
``ops/math_ops.py:92``, ``softmax_with_cross_entropy`` at
``ops/nn_ops.py:191``) and of ``paddle_tpu/nn/functional.py``.

Each casts its inputs under AMP with the op type the JAX package records
for it (:func:`~paddle_tpu_torch.amp.maybe_autocast_inputs`).
"""

from __future__ import annotations

import torch

from .. import flags
from ..amp.auto_cast import maybe_autocast_inputs
from ..ops.cuda.layer_norm import fused_layer_norm


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

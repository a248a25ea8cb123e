"""Functional forms of the layers and the loss the GPT slice uses — the
counterparts of the matching lowerings in ``paddle_tpu/ops``
(``layer_norm`` at ``ops/nn_ops.py:354``, ``gelu`` at
``ops/math_ops.py:92``, ``softmax_with_cross_entropy`` at
``ops/nn_ops.py:191``) and of ``paddle_tpu/nn/functional.py``.

Each casts its inputs under AMP with the op type the JAX package records
for it (:func:`~paddle_tpu_torch.amp.maybe_autocast_inputs`).
"""

from __future__ import annotations

import torch

from ..amp.auto_cast import maybe_autocast_inputs


def add(x, y):
    """``x + y`` as the reference's ``elementwise_add`` (cast under AMP:
    the residual stream stays bf16 under O2)."""
    x, y = maybe_autocast_inputs("elementwise_add", x, y)
    return x + y


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the JAX package's ``[in, out]`` weight
    layout: a ``matmul_v2`` then an ``elementwise_add``."""
    x, weight = maybe_autocast_inputs("matmul_v2", x, weight)
    y = x @ weight
    return y if bias is None else add(y, bias)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with the biased variance, in the
    reference's order: ``(x - mean) * rsqrt(var + eps) * w + b``."""
    x, weight, bias = maybe_autocast_inputs("layer_norm", x, weight, bias)
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * weight + bias


def gelu(x):
    """GELU in the tanh form GPT-2 uses (``jax.nn.gelu(approximate=True)``)."""
    (x,) = maybe_autocast_inputs("gelu", x)
    return torch.nn.functional.gelu(x, approximate="tanh")


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
